"""The port's ring-depth sweep (tools/kv_sweep.py) against the JAX
package's tiling sweep, on the CPU (the plain version; the depths are
checked and have no effect there)."""

import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import attention as tattn
from k8s_device_plugin_tpu_torch.tools import kv_sweep


def test_kv_sweep_rows_winner_and_agreement_guard():
    """The twin of tests/test_ops.py's sweep test at seq 128: every
    requested depth pair produces a row, the per-seq winner is named, and
    its forward is held against the dense oracle and the plain version."""
    r = kv_sweep.run_sweep([128], [(4, 2), (2, 3)], iters=1, inner=1, heads=2, device="cpu")
    assert len(r["rows"]) == 2
    assert {(row["fwd_stages"], row["bwd_stages"]) for row in r["rows"]} == {(4, 2), (2, 3)}
    assert all(row["timing"]["ms"] > 0 and row["shape"] == [4, 2, 128, 128]
               for row in r["rows"])
    win = r["best_by_seq"]["128"]
    assert win["ms"] > 0 and (win["fwd_stages"], win["bwd_stages"]) in {(4, 2), (2, 3)}
    assert r["agreement"]["128"]["ok"] is True
    assert r["agreement"]["128"]["vs_plain"]["ok"] is True
    assert r["ok"] is True
    assert r["backend"] == "cpu" and r["tool"] == "kv_sweep"


def test_report_keys_equal_the_jax_sweeps():
    """Run both sweeps at seq 128; with the tiling keys mapped to the depth
    keys, the report, its rows and its winners carry the same keys, and
    every JAX agreement key is in the port's (which adds ``vs_plain``)."""
    from k8s_device_plugin_tpu.tools.kv_sweep import run_sweep as jax_run_sweep

    jax_r = jax_run_sweep([128], [(64, 64)], iters=1, inner=1, heads=2)
    ours = kv_sweep.run_sweep([128], [(4, 2)], iters=1, inner=1, heads=2, device="cpu")
    mapping = {"block_q": "fwd_stages", "block_kv": "bwd_stages"}

    def mapped(keys):
        return {mapping.get(k, k) for k in keys}

    assert set(ours) == set(jax_r)
    assert {k for row in ours["rows"] for k in row} == mapped(
        k for row in jax_r["rows"] for k in row)
    assert set(ours["best_by_seq"]["128"]) == mapped(jax_r["best_by_seq"]["128"])
    assert set(jax_r["agreement"]["128"]) <= set(ours["agreement"]["128"])
    assert {"ms", "tflops"} <= set(ours["rows"][0]["timing"]) & set(jax_r["rows"][0]["timing"])


def test_a_wrong_forward_flips_ok(monkeypatch):
    """A forward whose every output is shifted by 0.25 passes no guard: the
    winner disagrees with the dense oracle and ``ok`` is false."""
    plain = tattn.flash_attention_fwd_plain

    def perturbed(q, k, v):
        o, lse = plain(q, k, v)
        return o + 0.25, lse

    monkeypatch.setattr(tattn, "flash_attention_fwd_plain", perturbed)
    r = kv_sweep.run_sweep([128], [(4, 2)], iters=1, inner=1, heads=2, device="cpu")
    assert r["agreement"]["128"]["ok"] is False
    assert r["ok"] is False


def test_a_failed_default_instance_flips_ok(monkeypatch):
    """A depth pair whose instance fails is an error row; the default pair
    failing (the main path's instance) makes the report not ok, another
    pair failing does not."""
    real = kv_sweep._bench_side

    def failing(fn, inner, iters, device):
        return {"error": "RuntimeError: flash_fwd: CUDA error 1 at launch"}

    monkeypatch.setattr(kv_sweep, "_bench_side", failing)
    r = kv_sweep.run_sweep([128], [(3, 3), (4, 2)], iters=1, inner=1, heads=2, device="cpu")
    assert [row.get("error", "")[:12] for row in r["rows"]] == ["RuntimeError"] * 2
    assert r["ok"] is False and r["best_by_seq"] == {}
    calls = iter([{"error": "RuntimeError: launch"}])
    monkeypatch.setattr(kv_sweep, "_bench_side",
                        lambda *a: next(calls, None) or real(*a))
    r = kv_sweep.run_sweep([128], [(3, 3), (4, 2)], iters=1, inner=1, heads=2, device="cpu")
    assert "error" in r["rows"][0] and "timing" in r["rows"][1]
    assert r["ok"] is True


@pytest.mark.parametrize("pair", [(5, 2), (1, 2), (4, 4), (4, 1)])
def test_unknown_depths_raise_on_the_cpu(pair):
    with pytest.raises(ValueError, match="ring depth"):
        kv_sweep.run_sweep([128], [pair], iters=1, inner=1, heads=2, device="cpu")
    q = k = v = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="ring depth"):
        tattn.flash_attention(q, k, v, fwd_stages=pair[0], bwd_stages=pair[1])


def test_every_built_depth_gives_the_plain_result_on_the_cpu():
    """On a CPU tensor every depth pair takes the same plain version, so
    outputs and gradients equal the default's bit for bit."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 40, 64, generator=gen) for _ in range(3))
    outs = []
    for fwd in tattn.FWD_STAGES:
        for bwd in tattn.BWD_STAGES:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = tattn.flash_attention(*leaves, fwd_stages=fwd, bwd_stages=bwd)
            o.square().sum().backward()
            outs.append([o.detach(), *(t.grad for t in leaves)])
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_cli_parses_depth_pairs():
    assert kv_sweep.parse_stages("4x2,3x2,2x3") == [(4, 2), (3, 2), (2, 3)]
