"""Each cell run by its command on the card, briefly: it exits 0 with a
correct result line that holds the cell's metrics. Marked ``cuda``; skips
inside the test where there are fewer cards than the cell's (``python3 -m
pytest gpubench/tests -m cuda`` on the machine with the cards)."""

import json
import subprocess
import sys

import pytest
import torch

from gpubench import run

CELLS = [w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, trace):
    cell = run.load_cell(name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA card(s)")
    done = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", name,
                           "--seed", str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=1200)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in wanted}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == cell.chips
