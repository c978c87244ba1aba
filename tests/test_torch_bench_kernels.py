"""The port's bench kernel leg (tools/bench_kernels.py) against bench.py's
helpers, and its window/merge state machine with an injected subprocess
runner (no card, no subprocess)."""

import copy

import pytest

import bench
from k8s_device_plugin_tpu_torch.tools import bench_kernels as bk

MICRO = {
    "ok": True, "tier": "micro", "kernels": {
        "matmul_4096": {"matmul": {"ms": 0.14, "tflops": 980.0}},
        "attention_seq2048": {"flash": {"ms": 1.1}, "dense": {"ms": 4.0},
                              "speedup_vs_dense": 3.6},
        "attention_agreement": {"max_abs_diff": 0.0078, "ok": True},
    },
}
FULL = {
    "ok": True, "tier": "full", "kernels": {
        "matmul_4096": {"matmul": {"ms": 0.139, "tflops": 989.0}},
        "attention_seq8192": {"flash": {"ms": 4.2}, "dense": {"error": "OutOfMemoryError"}},
        "attention_seq2048": {"skipped": "budget exhausted"},
        "attention_agreement": {"error": "RuntimeError: boom"},
        "xent_8192x2048x32768": {"chunked": {"ms": 30.0}, "dense": {"ms": 25.0}, "ok": True},
        "rmsnorm_8192x4096": {"skipped": "budget exhausted"},
    },
}
CASES = [
    {"matmul": {"ms": 0.1}},
    {"matmul": {"ms": 0}},
    {"matmul": {"error": "x"}},
    {"skipped": "budget exhausted"},
    {"error": "RuntimeError"},
    {"max_abs_diff": 0.01, "ok": True},
    {"max_abs_diff": 0.9, "ok": False},
    {"ok": True, "skipped": "x"},
    {"ok": True, "error": "x"},
    "not a case",
    None,
    {},
]
REPORTS = [MICRO, FULL, {"kernels": {}}, {"kernels": None}, {"ok": None, "partial": "devices_up"},
           None, "text", {"kernels": {"a": {"skipped": "x"}, "b": {"error": "y"}}}]


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_case_predicates_equal_bench(case):
    assert bk._case_has_numbers(case) == bench._case_has_numbers(case)
    assert bk._case_captured(case) == bench._case_captured(case)


@pytest.mark.parametrize("report", REPORTS, ids=range(len(REPORTS)))
def test_has_kernel_numbers_equals_bench(report):
    assert bk._has_kernel_numbers(report) == bench._has_kernel_numbers(report)


@pytest.mark.parametrize("micro, full", [
    (MICRO["kernels"], FULL["kernels"]),
    (FULL["kernels"], MICRO["kernels"]),
    ({}, FULL["kernels"]),
    (MICRO["kernels"], {}),
])
def test_merge_equals_bench(micro, full):
    ours = bk._merge_kernels(copy.deepcopy(micro), copy.deepcopy(full))
    assert ours == bench._merge_kernels(copy.deepcopy(micro), copy.deepcopy(full))


def test_merge_keeps_captured_micro_cases():
    merged = bk._merge_kernels(MICRO["kernels"], FULL["kernels"])
    assert merged["attention_seq2048"] == MICRO["kernels"]["attention_seq2048"]
    assert merged["attention_agreement"] == MICRO["kernels"]["attention_agreement"]
    assert merged["matmul_4096"] == FULL["kernels"]["matmul_4096"]
    assert merged["rmsnorm_8192x4096"] == {"skipped": "budget exhausted"}


def test_parse_report_takes_the_last_report_line():
    out = "\n".join(['{"kernels": {"a": 1}}', "noise", '{"other": 2}', '{"kernels": {"b": 2}}',
                     "{not json"])
    assert bk.parse_report(out) == {"kernels": {"b": 2}}
    assert bk.parse_report("nothing here") is None


class Runner:
    """Plays back (report, error) per call and records each call's args."""

    def __init__(self, *results):
        self.results = list(results)
        self.calls = []

    def __call__(self, args, timeout_s):
        self.calls.append((list(args), timeout_s))
        return copy.deepcopy(self.results.pop(0))


def test_stall_then_micro_capture_then_full_merge(monkeypatch):
    monkeypatch.setattr(bk, "FAST_FAILURE_PAUSE_S", 0.0)
    runner = Runner((None, "timed out after 30s"), (MICRO, None), (FULL, None))
    states = []
    out = bk.run_kernels(120, emit=lambda s: states.append(copy.deepcopy(s)), runner=runner)
    tiers = [("--tier" in args and args[args.index("--tier") + 1]) or "full"
             for args, _ in runner.calls]
    assert tiers == ["micro", "micro", "full"]
    assert all(args[0] == bk.MICROBENCH and "--stream" in args for args, _ in runner.calls)
    assert runner.calls[0][1] == 30.0  # the window
    assert [a["ok"] for a in out["attempts"]] == [False, True, True]
    assert [a["tier"] for a in out["attempts"]] == ["micro", "micro", "full"]
    assert out["kernels"] == bk._merge_kernels(MICRO["kernels"], FULL["kernels"])
    assert out["tier"] == "full"
    # emit after each state: the stalled window, the micro capture, the merge
    assert len(states) == 3
    assert states[0] == {"in_progress": True, "attempts": [out["attempts"][0]]}
    assert states[1]["tier"] == "micro" and bk._has_kernel_numbers(states[1])
    assert states[2]["kernels"] == out["kernels"]


def test_no_capture_within_the_attempt_cap(monkeypatch):
    monkeypatch.setattr(bk, "FAST_FAILURE_PAUSE_S", 0.0)
    runner = Runner(*[(None, "rc=1, no JSON on stdout")] * 3)
    states = []
    out = bk.run_kernels(120, emit=states.append, max_attempts=3, runner=runner)
    assert len(runner.calls) == 3 and len(states) == 3
    assert "error" in out and [a["ok"] for a in out["attempts"]] == [False] * 3


def test_a_budget_too_small_runs_nothing():
    runner = Runner()
    assert "skipped" in bk.run_kernels(10, runner=runner)
    assert runner.calls == []


def test_a_failed_full_tier_keeps_the_micro_capture(monkeypatch):
    runner = Runner((MICRO, None), (None, "timed out after 100s"))
    out = bk.run_kernels(120, runner=runner)
    assert out["kernels"] == MICRO["kernels"]
    assert [(a["tier"], a["ok"]) for a in out["attempts"]] == [("micro", True), ("full", False)]
