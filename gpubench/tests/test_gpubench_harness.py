"""A whole run of the harness at a tiny size on the CPU, past its look for
a card: sound, traced, with each fault planted under the port's training
step, and with the control in the program's place."""

import json
import math

import pytest
import torch

from gpubench import correct, faults, families, run
from gpubench.kinds import train

SEED = 2**31 + 11  # run seeds go past 32 signed bits


def test_sound_run_is_correct_and_reports_the_cells_metrics(tiny_cell):
    cell = tiny_cell("gpt2-xl.train")
    result = run.run_cell(cell, SEED, 0.5, False, device="cpu")
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    # The CPU has no allocator's peak to read: that metric is left out.
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end} - {"peak_mem_gib"}
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {*cell.limits, "failed_steps"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    json.dumps(result, allow_nan=False)


def test_traced_run_reads_per_layer_metrics(tiny_cell, short_trace):
    cell = tiny_cell("smoke-bench.train-xent4096", xent_chunk=64)
    result = run.run_cell(cell, SEED, 0.3, True, device="cpu")
    assert result["correct"] is True
    # The CPU has no device trace: only the host's span is read, and the
    # device's metrics are left out rather than read as 0.
    assert set(result["metrics"]) == {"dispatch_ms"}
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("kind", faults.KINDS)
def test_each_fault_makes_the_run_incorrect(tiny_cell, kind):
    cell = tiny_cell("gpt2-xl.train")
    with faults.planted(kind):
        result = run.run_cell(cell, SEED, 0.2, False, device="cpu")
    assert result["correct"] is False
    over = [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]
    assert over, result["checks"]


@pytest.mark.parametrize("name", ["gpt2-xl.train", "smoke-bench.train", "smoke-bench.train-xent4096"])
def test_control_fails_the_cells_limits(tiny_cell, name):
    """The reference one precision step lower (fp8 block products, TF32
    head), put in the program's place, reads over a limit of the cell."""
    cell = tiny_cell(name)
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    dev = torch.device("cpu")
    opt = cell.traffic["optimizer"]
    found = []
    for seed in (1, 2, 3):
        prog = train.start(cell, seed, dev).evidence
        ref = correct.reference_readings(fam, sz, seed, prog.batches, opt, dev)
        ctl = correct.reference_readings(fam, sz, seed, prog.batches, opt, dev, "control")
        checks = correct.checks(correct.gaps(ctl, ref, fam.HEAD_LEAVES), cell.limits)
        found.append(not all(c["ok"] for c in checks.values()))
        assert all(c["ok"] for c in correct.checks(correct.gaps(prog.readings, ref, fam.HEAD_LEAVES),
                                                   cell.limits).values())
    assert all(found)


def test_gaps_of_a_side_equal_to_the_reference_are_zero():
    r = correct.Readings([10.0, 9.5, 9.0], {"a": 1.0, "b": 2.0, "c": 1e-9},
                         {"a": 0.1, "b": 0.2, "c": 0.3})
    assert correct.gaps(r, r) == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    # The head's leaves alone: "c", all but still, is the worst leaf over
    # the median leaf's norm (1.0), and is not the head's.
    head = correct.Readings(r.losses, {"a": 1.1, "b": 2.0, "c": 0.5}, r.change_norms)
    assert correct.gaps(head, r, ("a",))["head_grad_gap"] == pytest.approx(0.1)
    assert correct.gaps(head, r)["grad_gap"] == pytest.approx(0.5)
    # "c" hardly moves in the reference: left out of the change.
    moved = correct.Readings(r.losses, r.grad_norms, {"a": 0.1, "b": 0.2, "c": 9.0})
    assert correct.gaps(moved, r)["change_gap"] == 0.0
    nan = correct.Readings([math.nan, 9.5, 9.0], r.grad_norms, r.change_norms)
    assert math.isnan(correct.gaps(nan, r)["loss_gap"])
    assert correct.checks({"loss_gap": math.nan}, {"loss_gap": 1.0})["loss_gap"]["ok"] is False


def test_window_reads_the_change_of_the_programs_counters():
    count = {"launches.k": 5}

    def step(_):
        count["launches.k"] += 2
        return torch.tensor(1.0)

    win = run._window(step, [None], 0, 0.0, False, lambda: dict(count))
    assert win["steps"] == 2 and win["counters"] == {"launches.k": 4}


def test_port_spans_started_in_the_traced_block_are_kept():
    from k8s_device_plugin_tpu_torch.utils import tracing

    with tracing.span("before"):
        pass
    with run._port_spans() as spans:
        with tracing.span("gpubench.inside"):
            pass
    assert [s["name"] for s in spans] == ["gpubench.inside"]
    assert not tracing.enabled()
