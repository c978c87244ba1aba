"""The port's kernel microbench on the CPU: schema, tiers, guards and the
verdict, at tiny shapes with the kernels' plain versions. Its times come
from a card only (chip_smoke.py runs the full tier there). Mirrors the
JAX package's microbench tests (tests/test_ops.py)."""

import json

from k8s_device_plugin_tpu_torch.ops import microbench as mb

CPU = mb.resolve_device("cpu")


def test_tiny_shapes_report_every_case():
    r = mb.run_microbench(iters=1, seqs=[128], rmsnorm_shape=(64, 128), inner=1,
                          matmul_n=256, device="cpu")
    assert r["backend"] == "cpu" and r["tier"] == "full"
    k = r["kernels"]
    assert list(k) == [
        "matmul_256", "attention_seq128", "attention_agreement",
        "xent_64x32x128", "rmsnorm_64x128",
        "head_nt_64x128x32", "head_nn_64x32x128", "head_tn_128x32x64",
    ]
    for name in ("head_nt_64x128x32", "head_nn_64x32x128", "head_tn_128x32x64"):
        assert {"kernel", "plain", "library", "bound_ms"} <= set(k[name])
        assert k[name]["kernel"]["rms_err"] < 1e-5
    assert k["xent_64x32x128"]["ok"] is True
    assert k["attention_agreement"]["ok"] is True
    assert "speedup_vs_dense" in k["attention_seq128"]
    assert {"kernel", "plain", "speedup_vs_plain"} <= set(k["rmsnorm_64x128"])
    assert all(k["attention_seq128"][side]["ms"] > 0 for side in ("flash", "dense"))
    assert r["ok"] is True and "timing_suspect" not in r


def test_micro_tier_is_three_cases_with_the_matmul_first():
    r = mb.run_microbench(iters=1, seqs=[128], inner=1, tier="micro", matmul_n=256,
                          device="cpu")
    assert r["tier"] == "micro"
    assert list(r["kernels"]) == ["matmul_256", "attention_seq128", "attention_agreement"]
    assert r["kernels"]["matmul_256"]["matmul"].get("ms") is not None
    assert r["kernels"]["attention_agreement"]["ok"] is True
    assert r["ok"] is True


def test_suspect_flag_trips_on_implausible_timing():
    """A peak of 1 FLOP/s and a memory rate of 1e-9 GB/s make every real
    time 'faster than the card', which is what a timing fault looks like."""
    attn = mb._attention_case(128, 1, 2, 128, iters=1, inner=1, peak_flops=1.0, device=CPU)
    assert attn["flash"]["suspect"] and attn["dense"]["suspect"]
    norm = mb._rmsnorm_case(64, 128, iters=1, inner=1, hbm_gbps=1e-9, device=CPU)
    assert norm["kernel"]["suspect"] and norm["plain"]["suspect"]
    xent = mb._xent_case(64, 32, 128, 32, iters=1, inner=1, peak_flops=1.0, device=CPU)
    assert xent["chunked"]["suspect"]
    report = {"ok": True, "kernels": {"rmsnorm": norm}}
    mb._update_verdict(report)
    assert report["timing_suspect"] is True and report["ok"] is True


def test_budget_skips_are_recorded_and_keep_ok(capsys):
    r = mb.run_microbench(iters=1, budget_s=0.001, seqs=[128], inner=1, device="cpu",
                          stream=True)
    assert all("skipped" in v for v in r["kernels"].values())
    assert r["ok"] is True
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    # A skipped case prints no partial line; only the devices-up one came.
    assert len(lines) == 1
    assert lines[0]["partial"] == "devices_up" and lines[0]["ok"] is None


def test_an_error_on_a_kernel_side_fails_the_run():
    """An error on the flash or RMSNorm kernel side sets ok false; one on
    a dense or plain side is a result and does not."""
    def case(**sides):
        return {"ok": True, "kernels": {"c": {"shape": [1], **sides}}}

    for sides, ok in (
        ({"flash": {"error": "RuntimeError: x"}, "dense": {"ms": 1.0}}, False),
        ({"kernel": {"error": "RuntimeError: x"}, "plain": {"ms": 1.0}}, False),
        ({"flash": {"ms": 1.0}, "dense": {"error": "OutOfMemoryError: x"}}, True),
        ({"kernel": {"ms": 1.0}, "plain": {"error": "RuntimeError: x"}}, True),
    ):
        report = case(**sides)
        mb._update_verdict(report)
        assert report["ok"] is ok, sides
    report = {"ok": True, "kernels": {"c": {"error": "ValueError: x"}}}
    mb._update_verdict(report)
    assert report["ok"] is False


def test_a_failing_kernel_side_is_contained_and_reported():
    def broken():
        raise RuntimeError("kernel refused its inputs")

    side = mb._bench_side(broken, inner=1, iters=1, device=CPU)
    assert side == {"error": "RuntimeError: kernel refused its inputs"}


def test_main_on_cpu_prints_one_report(capsys):
    assert mb.main(["--device", "cpu", "--tier", "micro", "--seqs", "128", "--iters", "1",
                    "--inner", "1", "--matmul-n", "128"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0])["ok"] is True
