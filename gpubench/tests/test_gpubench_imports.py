"""The harness loads no JAX and nothing of the JAX package, whose name is
a prefix of the port's; and it refuses to run without the cell's cards or
without the port beside it, printing no result."""

import shutil
import subprocess
import sys
import types

from gpubench import run

CPU_RUN = """
import dataclasses, sys
from gpubench import run
cell = run.load_cell("smoke-bench.train")
cell = dataclasses.replace(cell, config=dict(cell.config, vocab_size=256, n_positions=32,
    n_embd=128, n_layer=2, n_head=2, n_inner=256), traffic=dict(cell.traffic, batch=2))
run.run_cell(cell, 7, 0.2, False, device="cpu")
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", CPU_RUN], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(out.strip().splitlines()[-1].split(","))
    assert "k8s_device_plugin_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "k8s_device_plugin_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "k8s_device_plugin_tpu_torch", types.ModuleType("x"))
    for name in ("jax", "jaxlib", "flax", "k8s_device_plugin_tpu"):
        sys.modules.pop(name, None)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "k8s_device_plugin_tpu.workload", types.ModuleType("y"))
    assert run.forbidden_modules() == ["k8s_device_plugin_tpu"]


def _cli(cwd):
    return subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "gpt2-xl.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_cli_exits_2_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        import pytest

        pytest.skip("a card is present")
    done = _cli(run.ROOT)
    assert done.returncode == 2 and done.stdout == ""


def test_without_the_port_beside_it_the_cli_fails_and_prints_no_result(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    done = _cli(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
