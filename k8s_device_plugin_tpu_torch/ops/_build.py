"""Build the hand-written CUDA kernels at first use and load them.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, all sources in parallel, and
loaded with ``ctypes``. Nothing is compiled when a module is imported: the
first kernel call (or ``build_all()``) builds. The output lands in
``build/`` beside this file (listed in ``.gitignore``), named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused.

Calling convention of every C entry point: each pointer and the stream
are ``c_void_p``, sizes ``c_int``, scalars ``c_float``; the function
returns ``cudaGetLastError()`` after its launch, and ``check()`` raises
when that is not 0.

``LAUNCHES`` is the one launch table of every kernel wrapper: each adds
one to its kernel's count where it launches it, and nowhere else, so a run
can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"

# Launches of each hand-written kernel since the last reset_launches().
LAUNCHES = {
    "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_bwd_delta": 0, "rmsnorm": 0,
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else /usr/local/cuda, else $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on the machine with "
            "the card (set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no current build, one ``nvcc``
    per source, all started together. Returns ptxas' report (registers,
    shared memory, spills) per freshly built source; empty when every
    library was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"{src.stem}-{digest}.so"
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        jobs[src.stem] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    logs, failed = {}, []
    for stem, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    build_all()
    path = BUILD_DIR / f"{stem}-{_digest()}.so"
    if not path.exists():
        raise FileNotFoundError(f"no kernel source csrc/{stem}.cu")
    return ctypes.CDLL(str(path))


def bind(stem: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of ``csrc/<stem>.cu`` with its argument types set
    (pointers and the stream must be ``c_void_p``, or ctypes cuts them to
    32 bits) and an ``int`` (cudaError_t) result."""
    fn = getattr(library(stem), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
