"""Build the hand-written CUDA kernels at first use and load them.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, all sources in parallel, and
loaded with ``ctypes``. Nothing is compiled when a module is imported: the
first kernel call (or ``build_all()``) builds. The output lands in
``$TPU_WORKLOAD_COMPILATION_CACHE_DIR`` when it is set (a volume a
restarted pod reads its build back from, ``utils/compilation_cache.py``),
else in ``build/`` beside this file (listed in ``.gitignore``), named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. A build directory that cannot be created or
written raises; the build never moves elsewhere.

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
CACHE_DIR_ENV = "TPU_WORKLOAD_COMPILATION_CACHE_DIR"

# Launches of each hand-written kernel since the last reset_launches().
LAUNCHES = {
    "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_bwd_delta": 0, "rmsnorm": 0,
    "head_gemm": 0,
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


def usable_dir(path: Path) -> Path:
    """``path``, created if missing; raises when it cannot hold a build (a
    file or a dangling link in its place, a read-only mount)."""
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"kernel build directory {path} cannot be used: {e}") from e
    if not os.access(path, os.W_OK | os.X_OK):
        raise RuntimeError(f"kernel build directory {path} is not writable")
    return path


def build_dir() -> Path:
    """Where the kernels are built: ``$TPU_WORKLOAD_COMPILATION_CACHE_DIR``
    when set, else ``BUILD_DIR``; checked by ``usable_dir``."""
    return usable_dir(Path(os.environ.get(CACHE_DIR_ENV) or BUILD_DIR))


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
    out_dir = build_dir()
    digest = _digest()
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = out_dir / f"{src.stem}-{digest}.so"
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
    path = build_dir() / f"{stem}-{_digest()}.so"
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
