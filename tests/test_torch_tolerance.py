"""The rule that holds each flash kernel's bf16 output against its plain
version (``bf16_agreement`` in ``ops/attention.py``), at the bench's
sequence length and head dim.

It must pass a correct kernel, which rounds at the same places as the
plain version but sums in another order and rounds P against a running
max; stand-ins here are a tiled online-softmax forward and a float64
backward. It must reject the faults a tiled kernel typically has, emulated
in plain PyTorch: a dropped rescale, an off-by-one causal mask, a skipped
or mis-weighted tile, a missing term; and those of a ring-buffered,
warp-specialised kernel: in the backward a stage read one tile late (lse,
delta or dO), a diagonal tile left unmasked, a ragged tile filled from the
next head's rows instead of zeros; in the forward a K/V stage read one tile
late, the second consumer warpgroup's rows given the first's softmax
state, a ragged q block's rows past seq stored over the next head's first
rows. Imports no JAX.
"""

import math

import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import attention as tattn

SHAPE = (1, 2, 2048, 128)  # one batch row, two heads, of the bench shape
RAGGED = (1, 3, 100, 128)  # seq 100: the second 64-row q tile runs 28 rows past seq
TILE = 64
BLOCK = 128  # q rows of a forward block: two consumer warpgroups of 64
# A ring stage read one tile late in the dK/dV kernel: dS built from the
# previous q tile's lse or delta, or dO taken from the previous stage.
STALE_STAGE_FAULTS = ("dkv_stale_lse_stage", "dkv_stale_delta_stage", "dkv_stale_do_stage")


@pytest.fixture(scope="module")
def inputs():
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(SHAPE, generator=gen).to(torch.bfloat16) for _ in range(4))
    o, lse = tattn.flash_attention_fwd_plain(q, k, v)
    return q, k, v, do, o, lse


def _tiled_forward(q, k, v, rescale_acc=True, causal_offset=0, last_tile_weight=1.0,
                   stale_kv=False, shared_state=False):
    """Online softmax over 64-key tiles, as the forward kernel runs it; the
    keyword arguments inject faults."""
    n, d = q.shape[-2:]
    if stale_kv:
        k, v = _previous_tile(k), _previous_tile(v)
    qf = q.float()
    rows = torch.arange(n)[:, None]
    m = torch.full((*q.shape[:-1], 1), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for t0 in range(0, n, TILE):
        cols = torch.arange(t0, min(t0 + TILE, n))[None, :]
        s = (1.0 / math.sqrt(d)) * (qf @ k[..., t0:t0 + TILE, :].float().transpose(-1, -2))
        s = s.masked_fill(cols > rows + causal_offset, tattn.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        if shared_state:
            m_new = _first_warpgroup_rows(m_new)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        # The tile that holds each row's diagonal is its last one.
        weight = torch.where((rows // TILE) == t0 // TILE, last_tile_weight, 1.0)
        pv = p.to(v.dtype).float() @ v[..., t0:t0 + TILE, :].float()
        l = alpha * l + p.sum(-1, keepdim=True)
        if shared_state:
            l = _first_warpgroup_rows(l)
        acc = (alpha * acc if rescale_acc else acc) + weight * pv
        m = m_new
    return (acc / l).to(q.dtype)


def _first_warpgroup_rows(t):
    """``t`` (rows on dim -2) with rows 64..127 of every 128-row block
    replaced by rows 0..63: the second consumer warpgroup of a forward block
    given the first's softmax state (running max or denominator)."""
    rows = torch.arange(t.shape[-2])
    return t[..., torch.where(rows % BLOCK >= TILE, rows - TILE, rows), :]


def _fwd_ragged_spill(q, k, v):
    """O as a forward computes it that stores whole 128-row q blocks through
    the flattened (b*h*seq, d) view: each head's rows past seq (zero q rows,
    attending causally over zero-filled keys) land on the next head's first
    rows, after that head's own stores."""
    b, h, n, d = q.shape
    extra = -n % BLOCK

    def pad(t):
        return torch.cat([t, t.new_zeros(b, h, extra, d)], dim=2)

    o_pad, _ = tattn.flash_attention_fwd_plain(pad(q), pad(k), pad(v))
    o = o_pad[..., :n, :].reshape(b * h, n, d).clone()
    o[1:, :extra] = o_pad[..., n:, :].reshape(b * h, extra, d)[:-1]
    return o.reshape(b, h, n, d)


def _previous_tile(t):
    """Each 64-row tile of ``t`` (rows on dim -2) replaced by the one before
    it, the first kept: what a ring stage read one tile late holds."""
    return torch.cat([t[..., :TILE, :], t[..., :-TILE, :]], dim=-2)


def _backward(q, k, v, o, lse, do, dtype=torch.float32, fault=None):
    """(dq, dk, dv) with the kernels' roundings, summed in ``dtype``;
    ``fault`` injects one. The ring faults reach only the pass that streams
    the operand: lse, delta and dO stream through the dK/dV kernel's ring,
    while the dQ kernel keeps its q rows resident."""
    n, d = q.shape[-2:]
    qf, kf, vf, of, dof = (t.to(dtype) for t in (q, k, v, o, do))
    rows, cols = torch.arange(n)[:, None], torch.arange(n)[None, :]
    s = (1.0 / math.sqrt(d)) * (qf @ kf.transpose(-1, -2))
    masked = cols > rows
    if fault == "diagonal_tile_unmasked":
        masked = masked & ((rows // TILE) != (cols // TILE))
    s = s.masked_fill(masked, tattn.NEG_INF)
    lse = lse.to(dtype).reshape(*q.shape[:-1], 1)
    p = torch.exp(s - lse)
    dp = dof @ vf.transpose(-1, -2)
    delta = 0.0 if fault == "no_delta" else (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if fault == "dq_skips_diagonal_tile":
        ds_q = ds.masked_fill((rows // TILE) == (cols // TILE), 0.0)
    else:
        ds_q = ds
    dof_kv = dof
    if fault == "dkv_stale_do_stage":
        dof_kv = _previous_tile(dof)
    elif fault == "dkv_stale_lse_stage":
        p = torch.exp(s - _previous_tile(lse))
    elif fault == "dkv_stale_delta_stage":
        delta = _previous_tile(delta)
    if fault in STALE_STAGE_FAULTS:
        ds = p * (dof_kv @ vf.transpose(-1, -2) - delta)
    if fault == "dkv_skips_last_q_tile":
        p, ds = p.masked_fill(rows >= n - TILE, 0.0), ds.masked_fill(rows >= n - TILE, 0.0)
    lo = lambda t: t.to(torch.bfloat16).to(dtype)  # noqa: E731
    scale = 1.0 / math.sqrt(d)
    dq = scale * (lo(ds_q) @ kf)
    dk = scale * (lo(ds).transpose(-1, -2) @ qf)
    dv = lo(p).transpose(-1, -2) @ dof_kv
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def test_rule_passes_correct_stand_ins(inputs):
    q, k, v, do, o, lse = inputs
    fwd = tattn.bf16_agreement(_tiled_forward(q, k, v), o)
    assert fwd["ok"], fwd
    assert 0 < fwd["max_abs_err"]  # the stand-in really rounds differently
    plain = (tattn.flash_dq_plain(q, k, v, o, lse, do),
             *tattn.flash_dkv_plain(q, k, v, o, lse, do))
    for got, want in zip(_backward(q, k, v, o, lse, do, torch.float64), plain):
        agree = tattn.bf16_agreement(got, want)
        assert agree["ok"], agree


@pytest.mark.parametrize(
    "fault",
    ["fwd_no_acc_rescale", "fwd_causal_off_by_one", "fwd_diagonal_tile_weight",
     "fwd_stale_kv_stage", "fwd_second_warpgroup_shares_state",
     "fwd_ragged_rows_into_next_head", "no_delta", "dq_skips_diagonal_tile", "dkv_skips_last_q_tile",
     *STALE_STAGE_FAULTS, "diagonal_tile_unmasked"],
)
def test_rule_rejects_kernel_faults(inputs, fault):
    q, k, v, do, o, lse = inputs
    if fault == "fwd_ragged_rows_into_next_head":
        gen = torch.Generator().manual_seed(1)
        rq, rk, rv = (torch.randn(RAGGED, generator=gen).to(torch.bfloat16) for _ in range(3))
        outs = [(_fwd_ragged_spill(rq, rk, rv), tattn.flash_attention_fwd_plain(rq, rk, rv)[0])]
    elif fault.startswith("fwd_"):
        kw = {
            "fwd_no_acc_rescale": dict(rescale_acc=False),
            "fwd_causal_off_by_one": dict(causal_offset=1),
            "fwd_diagonal_tile_weight": dict(last_tile_weight=1.01),
            "fwd_stale_kv_stage": dict(stale_kv=True),
            "fwd_second_warpgroup_shares_state": dict(shared_state=True),
        }[fault]
        outs = [(_tiled_forward(q, k, v, **kw), o)]
    else:
        plain = (tattn.flash_dq_plain(q, k, v, o, lse, do),
                 *tattn.flash_dkv_plain(q, k, v, o, lse, do))
        outs = zip(_backward(q, k, v, o, lse, do, fault=fault), plain)
    verdicts = [tattn.bf16_agreement(got, want) for got, want in outs]
    assert not all(a["ok"] for a in verdicts), verdicts


def _dkv_padded(q, k, v, lse, do, delta, fill):
    """(dk, dv) as a dK/dV kernel computes them that streams whole 64-row q
    tiles and masks only causally, trusting the load to zero the rows past
    seq. ``fill`` is what those rows of q, dO, lse and delta hold: "zeros"
    (a load per head that fills past seq), or "next_head" (a load from the
    flattened (b*h*seq, d) view, which reads the next head's first rows)."""
    b, h, n, d = q.shape
    extra = -n % TILE

    def pad(t):  # t: (b*h, n, ...) -> (b*h, n + extra, ...)
        if fill == "zeros":
            tail = t.new_zeros((b * h, extra, *t.shape[2:]))
        else:
            tail = torch.cat([t[1:, :extra], t.new_zeros((1, extra, *t.shape[2:]))])
        return torch.cat([t, tail], dim=1)

    qp, dop = (pad(t.double().reshape(b * h, n, d)) for t in (q, do))
    lsep, deltap = (pad(t.double().reshape(b * h, n))[..., None] for t in (lse, delta))
    kf, vf = (t.double().reshape(b * h, n, d) for t in (k, v))
    rows, cols = torch.arange(n + extra)[:, None], torch.arange(n)[None, :]
    scale = 1.0 / math.sqrt(d)
    s = (scale * (qp @ kf.transpose(-1, -2))).masked_fill(cols > rows, tattn.NEG_INF)
    p = torch.exp(s - lsep)
    ds = p * (dop @ vf.transpose(-1, -2) - deltap)
    lo = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
    dk = scale * (lo(ds).transpose(-1, -2) @ qp)
    dv = lo(p).transpose(-1, -2) @ dop
    return tuple(t.reshape(b, h, n, d).to(torch.bfloat16) for t in (dk, dv))


@pytest.mark.parametrize("fill,passes", [("zeros", True), ("next_head", False)])
def test_rule_rejects_a_ragged_tile_read_from_the_next_head(fill, passes):
    gen = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(RAGGED, generator=gen).to(torch.bfloat16) for _ in range(4))
    o, lse = tattn.flash_attention_fwd_plain(q, k, v)
    delta = tattn.flash_bwd_delta_plain(o, do)
    got = _dkv_padded(q, k, v, lse, do, delta, fill)
    verdicts = [tattn.bf16_agreement(g, w)
                for g, w in zip(got, tattn.flash_dkv_plain(q, k, v, o, lse, do))]
    assert all(a["ok"] for a in verdicts) == passes, verdicts
