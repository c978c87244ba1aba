"""The port's step spans placed on the traced window (``metrics/_spans.py``)
and the five readers of them, on a trace and spans made up by hand, and
on a traced run of the tiny cell on the CPU."""

import types

import pytest
from torch.autograd import DeviceType

from gpubench import run, trace
from gpubench.metrics import _spans

READERS = ("host_issue_ms", "idle_forward_ms", "idle_backward_ms", "idle_optimizer_ms",
           "idle_other_ms")
EPOCH_NS = 1_760_000_000_123_456_789  # the spans' clock at the window's opening
W0 = 1000.0  # the window's opening on the trace's clock (us)


def ev(name, start_ms, end_ms, device=DeviceType.CPU):
    """An event of the made-up trace, its times in ms from the window's opening."""
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=False,
                                 time_range=types.SimpleNamespace(start=W0 + start_ms * 1e3,
                                                                  end=W0 + end_ms * 1e3))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def card(start_ms, end_ms, name="nvjet_tst_gemm"):
    return ev(name, start_ms, end_ms, DeviceType.CUDA)


SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
# Two steps, each with its three phases (ms from the window's opening).
STEPS = [(1.0, 4.0, [(1.2, 2.0), (2.2, 3.0), (3.1, 3.8)]),
         (5.0, 8.0, [(5.2, 6.0), (6.2, 7.0), (7.1, 7.8)])]
# Busy 0-1.5, 1.503-2.5, 2.6-3.9, 5.4-7.7, 7.75-9.5 of a 10 ms window:
# gaps of 3 us, then 0.1 ms in backward; 1.5 ms from step 1's own time
# (0.1) through the loop (1.0) and step 2's own time (0.2) into its
# forward (0.2); 0.05 ms in optimizer; 0.5 ms after the last step.
BUSY = [(0.0, 1.5), (1.503, 2.5), (2.6, 3.9), (5.4, 7.7), (7.75, 9.5)]
LAUNCH_MS = [1.3, 2.5, 3.5, 5.3, 6.5, 7.5]


def made_up_trace(marker_launch_ms=8.0):
    events = [card(-0.02, 0.0, SPIN), card(10.0, 10.001, SPIN),
              ev("cudaLaunchKernel", -0.03, -0.025),  # the opening marker's, before the window
              ev("cudaLaunchKernel", marker_launch_ms, marker_launch_ms + 0.01),
              ev("cudaMemsetAsync", 3.2, 3.4)]
    events += [card(a, b) for a, b in BUSY]
    events += [ev("cudaLaunchKernel", t, t + 0.01) for t in LAUNCH_MS]
    return trace.summarize(Prof(events), steps=len(STEPS))


def made_up_spans(offset_ns=EPOCH_NS):
    def ns(ms):
        return offset_ns + round(ms * 1e6)

    spans = []
    for i, (a, b, phases) in enumerate(STEPS):
        step = {"name": "train.step", "span_id": f"s{i}", "parent_span_id": "", "trace_id": f"t{i}",
                "start_ns": ns(a), "end_ns": ns(b), "service": "workload"}
        spans.append(step)
        spans += [{"name": name, "span_id": f"s{i}{j}", "parent_span_id": f"s{i}",
                   "trace_id": f"t{i}", "start_ns": ns(c), "end_ns": ns(d), "service": "workload"}
                  for j, (name, (c, d)) in enumerate(zip(_spans.PHASES, phases))]
    return spans


def context(summary, spans, dispatch_s=(0.004,)):
    window = {"seconds": 1.0, "steps": 2, "step_s": [0.5, 0.5], "dispatch_s": list(dispatch_s),
              "counters": {}}
    return run.Context(window=window, units_per_step=1000, peak_bytes=None, setup_s=1.0,
                       family=None, sizes=None, traffic={"batch": 1}, summary=summary,
                       spans=spans)


def flat(intervals):
    return [t for ab in intervals for t in ab]


def read_all(ctx):
    return {name: run.reader(name)(ctx) for name in READERS}


@pytest.mark.parametrize("offset_ns", [EPOCH_NS, EPOCH_NS + 987_654_321_012, 10**9])
def test_the_anchor_recovers_the_spans_offset(offset_ns):
    placed = _spans.place(context(made_up_trace(), made_up_spans(offset_ns)))
    assert placed is not None and placed.inside == 1.0
    assert flat(placed.steps) == pytest.approx([t / 1e3 for a, b, _ in STEPS for t in (a, b)],
                                               abs=1e-12)
    for k, phase in enumerate(_spans.PHASES):
        assert flat(placed.phases[phase]) == pytest.approx(
            [t / 1e3 for *_, phases in STEPS for t in phases[k]], abs=1e-12)


def test_readers_equal_the_hand_computed_split():
    s = made_up_trace()
    ctx = context(s, made_up_spans())
    got = read_all(ctx)
    # Per step (2): backward 0.1 ms, forward 0.2, optimizer 0.05; the rest
    # 0.1 + 1.0 + 0.2 + 0.5. Host: 6 ms of steps less 6 launches of 10 us
    # and a memset of 0.2 ms.
    assert got == pytest.approx({"idle_forward_ms": 0.1, "idle_backward_ms": 0.05,
                                 "idle_optimizer_ms": 0.025, "idle_other_ms": 0.9,
                                 "host_issue_ms": (6.0 - 0.06 - 0.2) / 2})
    idle_ms = run.reader("device_idle_pct")(ctx) / 100 * s.window_s * 1e3 / s.steps
    under_5us_ms = dict(s.idle_gaps)["(gaps under 5 us)"] * 1e3 / s.steps
    assert under_5us_ms == pytest.approx(0.0015)
    assert sum(v for k, v in got.items() if k.startswith("idle_")) == pytest.approx(
        idle_ms - under_5us_ms)
    assert got["host_issue_ms"] < run.reader("dispatch_ms")(ctx)


def test_a_placement_that_leaves_launches_outside_the_steps_reads_as_missing():
    # The marker's launch 0.5 ms late puts the spans 0.5 ms late: the
    # launches at 1.3 and 5.3 ms fall before their steps (2 of 6).
    late = context(made_up_trace(marker_launch_ms=8.5), made_up_spans())
    assert _spans.place(late) is None
    assert read_all(late) == dict.fromkeys(READERS)
    # One step's spans missing: fewer steps than the trace's.
    short = context(made_up_trace(), made_up_spans()[:4])
    assert read_all(short) == dict.fromkeys(READERS)
    for ctx in (context(None, made_up_spans()), context(made_up_trace(), [])):
        assert read_all(ctx) == dict.fromkeys(READERS)


def test_one_launch_in_a_hundred_outside_is_tolerated_and_two_are_not():
    s = made_up_trace()
    launch = next(e for e in s.events if e.name == "cudaLaunchKernel" and e.start_s > 0.001)
    inside = [launch] * 98

    def with_outside(n):
        outside = [trace.Event("cudaLaunchKernel", False, 4.5e-3, 4.51e-3)] * n
        events = sorted(s.events + inside + outside, key=lambda e: e.start_s)
        return context(trace.Summary(**{**vars(s), "events": events}), made_up_spans())

    assert _spans.place(with_outside(1)).inside == pytest.approx(104 / 105)
    assert _spans.place(with_outside(2)) is None


def test_traced_cpu_run_records_one_step_span_a_traced_step(tiny_cell, short_trace, monkeypatch):
    """A traced run of the tiny cell on the CPU: a ``train.step`` with its
    three phases, nested in order inside it, for each traced step. The CPU
    has no card activity, so nothing is placed and the five readers leave
    their metrics out of the line, as every device metric is there."""
    seen = []
    reader = run.reader

    def keeping(name):
        read = reader(name)
        return lambda ctx: seen.append(ctx) or read(ctx)

    monkeypatch.setattr(run, "reader", keeping)
    monkeypatch.setattr(run, "TRACE_SECONDS", 1.0)  # several steps on a loaded CPU
    result = run.run_cell(tiny_cell(), 2**31 + 7, 0.3, True, device="cpu")
    assert result["correct"] is True and set(result["metrics"]) == {"dispatch_ms"}
    ctx = seen[0]
    steps = sorted((sp for sp in ctx.spans if sp["name"] == "train.step"),
                   key=lambda sp: sp["start_ns"])
    assert len(steps) == ctx.summary.steps >= 2
    assert sorted(sp["name"] for sp in ctx.spans) == sorted(
        ["train.step", *_spans.PHASES] * ctx.summary.steps)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(steps, steps[1:]))
    for step in steps:
        children = sorted((sp for sp in ctx.spans if sp["parent_span_id"] == step["span_id"]),
                          key=lambda sp: sp["start_ns"])
        assert [sp["name"] for sp in children] == list(_spans.PHASES)
        assert all(sp["trace_id"] == step["trace_id"] for sp in children)
        assert step["start_ns"] <= children[0]["start_ns"]
        assert children[-1]["end_ns"] <= step["end_ns"]
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(children, children[1:]))
    assert _spans.place(ctx) is None
    assert all(run.reader(name)(ctx) is None for name in READERS)
