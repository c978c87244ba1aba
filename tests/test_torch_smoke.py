"""The PyTorch port's smoke workload, device policy, accelerator table and
package boundary, on the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from k8s_device_plugin_tpu_torch import device as tdevice
from k8s_device_plugin_tpu_torch.ops import _build
from k8s_device_plugin_tpu_torch.workload import chips, smoke
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "k8s_device_plugin_tpu_torch"
# The JAX package's name is a prefix of the port's: match it alone.
JAX_PACKAGE = re.compile(r"k8s_device_plugin_tpu(?!_torch)")


def test_run_smoke_on_cpu_tiny_is_ok():
    streamed = []
    report = smoke.run_smoke(
        steps=3, cfg=ModelConfig.tiny(), device="cpu", emit=streamed.append
    )
    assert report["ok"] is True
    assert report["first_loss_sane"] and report["loss_decreased"]
    assert report["backend"] == "cpu" and report["mfu"] is None
    assert report["kernel_launches"] == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_bwd_delta": 0, "rmsnorm": 0}
    assert report["xent_chunk"] == 0
    assert [s["partial"] for s in streamed] == ["devices_up", "first_step"]
    assert all(s["ok"] is None for s in streamed)


def test_main_on_cpu_prints_the_report(capsys):
    assert smoke.main(["--device", "cpu", "--steps", "2", "--no-stream"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["ok"] is True


def test_main_takes_the_bench_legs_flags(capsys):
    """The JAX bench leg's smoke flags: --inner-steps and --ab-xent-chunk."""
    assert smoke.main(["--device", "cpu", "--steps", "2", "--inner-steps", "2",
                       "--ab-xent-chunk", "32", "--no-stream"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert len(lines) == 1 and report["ok"] is True and report["inner_steps"] == 2
    assert report["ab"]["variant_xent_chunk"] == 32 and "vs_plain_step" in report["ab"]
    assert "error" not in report["ab"]


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke.run_smoke(steps=1, cfg=ModelConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(ModelConfig.tiny())
    model = init_model(ModelConfig.tiny(), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_peak_flops_table():
    assert chips.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert chips.peak_flops_for("NVIDIA H100 PCIe") == 756e12
    assert chips.peak_flops_for("NVIDIA H100 NVL") == 835e12
    assert chips.peak_flops_for("cpu") is None
    assert chips.peak_flops_for("TPU v5 lite") is None


def test_memory_rate_and_f32_peak_table():
    rates = {kind: (chips.card_spec(kind).memory_bytes_per_s, chips.card_spec(kind).peak_f32_flops)
             for kind in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL")}
    assert rates == {
        "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
        "NVIDIA H100 PCIe": (2.0e12, 51e12),
        "NVIDIA H100 NVL": (3.9e12, 60e12),
    }
    assert chips.card_spec("cpu") is None


@pytest.mark.parametrize(
    "env,expected",
    [
        ({}, None),
        ({"CUDA_VISIBLE_DEVICES": "0,1"}, 2),
        ({"NVIDIA_VISIBLE_DEVICES": "all", "TPU_PLUGIN_ALLOCATED_CHIPS": "4"}, 4),
        ({"NVIDIA_VISIBLE_DEVICES": "GPU-a,GPU-b,GPU-c"}, 3),
        ({"NVIDIA_VISIBLE_DEVICES": "none"}, 0),
        ({"CUDA_VISIBLE_DEVICES": "1", "NVIDIA_VISIBLE_DEVICES": "0,1,2,3"}, 1),
        ({"TPU_PLUGIN_ALLOCATED_CHIPS": "x"}, None),
    ],
)
def test_expected_device_count(monkeypatch, env, expected):
    for var in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES", "TPU_PLUGIN_ALLOCATED_CHIPS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert chips.expected_device_count() == expected


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has the CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_every_kernel_source_carries_its_note():
    sources = sorted((PACKAGE / "ops" / "csrc").glob("*.cu"))
    assert [s.name for s in sources] == ["flash_bwd.cu", "flash_fwd.cu", "rmsnorm.cu"]
    for src in sources:
        text = src.read_text()
        for needle in ("Replaces:", "What bounds", "What the design does"):
            assert needle in text, (src.name, needle)
        assert "extern \"C\"" in text and "cudaGetLastError" in text


def test_port_sources_import_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax)\b|^\s*(import|from)\s+"
        + JAX_PACKAGE.pattern, re.M,
    )
    offenders = [str(f) for f in files if banned.search(f.read_text())]
    assert offenders == []


def test_importing_the_port_loads_no_jax_in_a_fresh_process():
    """A subprocess: this test process already imported JAX (conftest)."""
    code = f"""
import importlib, pkgutil, re, sys
sys.path.insert(0, {str(ROOT)!r})
import k8s_device_plugin_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
       or re.match(r"{JAX_PACKAGE.pattern}", m)]
new = [m for m in names if m.split(".")[1] in ("api", "controller", "discovery", "dra",
                                                "health", "kube", "server", "supervisor",
                                                "tools", "topology")]
print(len(names), len(new), bad)
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env, check=True,
    ).stdout.split()
    # every module of the port was imported, the node daemon's and tools' 46 among them
    # (the operator's six tools included, tools/defrag.py, tools/lint.py and
    # tools/simreport.py)
    assert int(out[0]) >= 75 and int(out[1]) == 46
    assert out[2:] == ["[]"]


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the script would really run")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


class _Surfaces:
    """A local HTTP server answering the paths chip_smoke.py's Observer
    polls with ``bodies[path]`` (status 200)."""

    def __init__(self, bodies: dict):
        import http.server
        import threading

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = bodies.get(self.path.split("?")[0])
                self.send_response(200 if body is not None else 404)
                self.end_headers()
                self.wfile.write(body or b"")

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


GOOD_SURFACES = {"/healthz": b"ok", "/metrics": b'# TYPE x gauge\nx{a="b"} 1\n',
                 "/debug/telemetry": b'{"enabled": true}', "/debug/audit": b'{"enabled": true}'}


@pytest.mark.parametrize("fault", ["none", "metrics_not_text_format", "debug_not_json",
                                   "never_started"])
def test_chip_smoke_observer_fails_the_run_on_a_bad_poll(fault):
    """A poll that raises in the Observer's thread (a malformed /metrics
    line, a /debug body that is not JSON), or a thread that ended before
    stop(), fails the run from the caller's thread through check()."""
    import time

    import chip_smoke

    bodies = dict(GOOD_SURFACES)
    if fault == "metrics_not_text_format":
        bodies["/metrics"] = b"x{a=b} 1\n"
    elif fault == "debug_not_json":
        bodies["/debug/audit"] = b"<html>"
    surfaces = _Surfaces(bodies)
    observer = chip_smoke.Observer(surfaces.base)
    failures = []
    try:
        if fault != "never_started":
            observer.start()
            deadline = time.monotonic() + 10
            while (time.monotonic() < deadline and observer.error is None
                   and len(observer.polls) < 2):
                time.sleep(0.05)
        if fault in ("none", "never_started"):
            observer.check(failures.append)
        observer.stop()
        observer.check(failures.append)
    finally:
        observer.stop()
        surfaces.close()
    if fault == "none":
        assert failures == [] and len(observer.polls) >= 2
        assert observer.healthz[:2] == [200, 200]
    elif fault == "never_started":
        assert failures and "alive: False, stopped: False" in failures[0]
    else:
        assert failures and "poll failed" in failures[0]
        assert observer.polls == [] and not observer.is_alive()


def test_step_profile_groups_kernels_by_name():
    from k8s_device_plugin_tpu_torch.workload.step_profile import _group

    assert _group("void flash::fwd_kernel<128>(__nv_bfloat16 const*)") == "flash_fwd"
    assert _group("void flash::fwd_kernel<128>(CUtensorMap_st, CUtensorMap_st, float*)") \
        == "flash_fwd"
    assert _group("void flash::dkv_kernel<128>(__nv_bfloat16 const*)") == "flash_bwd"
    assert _group("void flash::dkv_kernel<128>(CUtensorMap_st, CUtensorMap_st)") == "flash_bwd"
    assert _group("void flash::dq_kernel<64>(CUtensorMap_st, float const*)") == "flash_bwd"
    assert _group("void flash::bwd_delta_kernel<128>(__nv_bfloat16 const*, float*, int)") \
        == "flash_bwd"
    assert _group("void rmsnorm::fwd_kernel<__nv_bfloat16, float>(__nv_bfloat16 const*)") \
        == "rmsnorm"
    assert _group("cutlass_80_simt_sgemm_256x128_8x4_nn_align1") == "matmul_f32"
    assert _group("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT") == "matmul"
    assert _group("multi_tensor_apply_kernel") == "optimizer"
    assert _group("at::native::vectorized_elementwise_kernel") == "other"
