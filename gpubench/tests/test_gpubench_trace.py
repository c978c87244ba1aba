"""The traced window's reduction, on a trace made up by hand: what ran on
the card, its union, its groups and the idle gaps by host operation."""

import types

import pytest
from torch.autograd import DeviceType

from gpubench import run, trace
from gpubench.metrics import _groups


def ev(name, start, end, device=DeviceType.CUDA, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


CPU = DeviceType.CPU
EVENTS = [
    ev(trace.WINDOW, 100.0, 1100.0, CPU, annotation=True),
    ev(trace.WINDOW, 100.0, 1100.0, annotation=True),  # the annotation's device range
    ev("aten::mm", 90.0, 150.0, CPU),
    ev("cudaLaunchKernel", 380.0, 420.0, CPU),
    ev("before the window", 0.0, 120.0),  # clipped to 100-120
    ev("void flash::fwd_kernel<64, 4>", 150.0, 350.0),
    ev("nvjet_hsh_gemm", 300.0, 400.0),  # overlaps the flash kernel
    ev("void flash::dkv_kernel<64, 2>", 500.0, 900.0),
    ev("Memset (Device)", 1000.0, 1050.0),
]


def test_summary_of_a_made_up_trace():
    s = trace.summarize(Prof(EVENTS), steps=2)
    assert s.window_s == pytest.approx(1000e-6)
    # busy: 100-120, 150-400, 500-900, 1000-1050
    assert s.busy_s == pytest.approx(720e-6)
    assert s.group_s == pytest.approx({"other": 70e-6, "flash_fwd": 200e-6, "matmul": 100e-6,
                                       "flash_bwd": 400e-6})
    assert s.flash == {"fwd": (pytest.approx(200e-6), 1), "dkv": (pytest.approx(400e-6), 1)}
    assert s.device_ops[0] == ["void flash::dkv_kernel<64, 2>", pytest.approx(400e-6)]
    # gaps: 120-150 (aten::mm at 135), 400-500 (cudaLaunchKernel ends at
    # 420: none at 450), 900-1000 and 1050-1100 (none)
    gaps = dict(s.idle_gaps)
    assert gaps == {"aten::mm": pytest.approx(30e-6),
                    "(no CUDA call: the host in Python and PyTorch)": pytest.approx(250e-6)}


def test_marker_kernels_bound_the_window_on_the_card():
    # The card's trace: no host range, two spin kernels around the steps.
    events = [e for e in EVENTS if e.name != trace.WINDOW] + [
        ev("void at::cuda::(anonymous namespace)::spin_kernel(long)", 80.0, 100.0),
        ev("void at::cuda::(anonymous namespace)::spin_kernel(long)", 1100.0, 1101.0),
    ]
    s = trace.summarize(Prof(events), steps=2)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(720e-6)
    assert all("spin_kernel" not in name for name, _ in s.device_ops)
    with pytest.raises(RuntimeError, match="markers"):
        trace.summarize(Prof(events[:-1]), steps=2)


FAMILY = types.SimpleNamespace(flops_per_step=lambda sz, batch: 1e6 * batch,
                               flash_shape=lambda sz, batch, mesh: (batch, 1, 64, 64))


def context(summary, dispatch_s=(), steps=1, seconds=1.0, step_s=(1.0,), peak=None, spans=()):
    window = {"seconds": seconds, "steps": steps, "step_s": list(step_s),
              "dispatch_s": list(dispatch_s), "counters": {}}
    return run.Context(window=window, units_per_step=1000, peak_bytes=peak, setup_s=12.5,
                       family=FAMILY, sizes=None, traffic={"batch": 1}, summary=summary,
                       spans=list(spans))


def test_events_of_a_made_up_trace_are_kept_for_readers():
    s = trace.summarize(Prof(EVENTS), steps=2)
    on_card = [(e.name, e.start_s, e.end_s) for e in s.events if e.on_card]
    assert on_card[0] == ("before the window", 0.0, pytest.approx(20e-6))
    assert ("void flash::dkv_kernel<64, 2>", pytest.approx(400e-6), pytest.approx(800e-6)) in on_card
    host = {e.name for e in s.events if not e.on_card}
    assert host == {"aten::mm", "cudaLaunchKernel"}


def test_readers_of_a_made_up_trace():
    s = trace.summarize(Prof(EVENTS), steps=2)
    ctx = context(s, dispatch_s=[0.1, 0.3, 0.2], steps=2, seconds=1.0)
    assert run.reader("dispatch_ms")(ctx) == pytest.approx(200.0)
    assert run.reader("device_idle_pct")(ctx) == pytest.approx(28.0)
    assert run.reader("flash_ms")(ctx) == pytest.approx(0.3)
    assert run.reader("bf16_matmul_ms")(ctx) == pytest.approx(0.05)
    assert run.reader("xent_ms")(ctx) is None
    assert run.reader("mfu_pct")(ctx) == pytest.approx(100 * 1e6 / (989e12 * 0.5))
    from gpubench import arith

    bound = arith.flash_bound_s("fwd", 1, 1, 64, 64) + arith.flash_bound_s("dkv", 1, 1, 64, 64)
    assert run.reader("flash_roofline_pct")(ctx) == pytest.approx(100 * bound / 600e-6)


def test_readers_without_a_device_trace_return_nothing():
    ctx = context(None)
    for name in ("dispatch_ms", "device_idle_pct", "flash_ms", "mfu_pct", "flash_roofline_pct",
                 "peak_mem_gib"):
        assert run.reader(name)(ctx) is None
    assert _groups.ms_per_step(ctx, "matmul") is None


def test_end_to_end_readers_of_a_window():
    ctx = context(None, steps=4, seconds=2.0, step_s=[0.5] * 9 + [0.7], peak=3 * 2**30)
    assert run.reader("train_tokens_per_s")(ctx) == pytest.approx(4 * 1000 / 2.0)
    # statistics.quantiles' inclusive p90 of nine 0.5 and one 0.7
    assert run.reader("step_ms_p90")(ctx) == pytest.approx(520.0)
    assert run.reader("peak_mem_gib")(ctx) == pytest.approx(3.0)
    assert run.reader("setup_s")(ctx) == 12.5


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError, match="window"):
        trace.summarize(Prof(EVENTS[2:]), steps=1)
