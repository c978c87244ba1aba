"""Ring attention: causal self-attention with the sequence split over the
mesh's ``seq`` axis (context parallelism). The counterpart of the JAX
package's ``parallel/ring.py``.

Each rank of the seq group holds one contiguous shard of the sequence's
queries, keys and values. The K/V shards rotate one hop down the ring
(rank j sends to j + 1) between steps, so at step t a rank holds the shard
that started at rank (idx - t) mod N, and after N steps every query has
seen every key once. Each step folds its tile into an online-softmax state
(running max m, denominator l, accumulator acc, all f32), masked causally
by global positions.

JAX differentiates through ``lax.ppermute`` by transposing it; torch does
not differentiate through ``send``/``recv``, so ``ring_attention`` is an
``autograd.Function``. Its backward runs the ring again: each tile is
recomputed from q, K/V and the saved logsumexp, dQ accumulates locally,
and dK/dV travel with their K/V shard and take one more hop home.

The constants and roundings are the JAX function's, not the flash
kernels': q is scaled by the Python float ``1 / sqrt(d)`` in f32, the
products take the f32 upcast of K and V, masked scores are -1e30, and the
output is ``acc / max(l, 1e-30)`` cast to q's dtype. The products are
``torch.matmul`` (outside any kernel in JAX too).

``q_chunk`` > 0 (dividing the local shard) folds the queries in chunks of
that size, in the forward and in the backward, so that only a
``[b, h, q_chunk, s_local]`` score tile is live at a time.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _rotate(tensors, group, n: int, idx: int) -> list[torch.Tensor]:
    """Send each tensor one hop down the ring (to rank idx + 1) and return
    what arrives from rank idx - 1, in the same order."""
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    ops, out = [], []
    for t in tensors:
        buf = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        out.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _chunks(s_local: int, q_chunk: int) -> list[slice]:
    step = q_chunk if q_chunk and q_chunk < s_local else s_local
    return [slice(i, i + step) for i in range(0, s_local, step)]


def _scores(q32, k32, q_pos, kv_pos) -> torch.Tensor:
    """The f32 scores of one (q chunk) x (kv shard) tile, -1e30 where a key
    lies after its query."""
    s = q32 @ k32.transpose(-1, -2)
    return s.masked_fill(kv_pos[None, :] > q_pos[:, None], NEG_INF)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, q_chunk):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        b, h, s_local, d = q.shape
        scale = 1.0 / (d ** 0.5)
        q32 = q.float() * scale
        pos = torch.arange(s_local, device=q.device)
        q_pos = idx * s_local + pos
        m = torch.full((b, h, s_local, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for t in range(n):
            if t:
                k_cur, v_cur = _rotate((k_cur, v_cur), group, n, idx)
            kv_pos = (idx - t) % n * s_local + pos
            k32, v32 = k_cur.float(), v_cur.float()
            for c in _chunks(s_local, q_chunk):
                s = _scores(q32[:, :, c], k32, q_pos[c], kv_pos)
                m_new = torch.maximum(m[:, :, c], s.amax(-1, keepdim=True))
                p = torch.exp(s - m_new)
                alpha = torch.exp(m[:, :, c] - m_new)
                l[:, :, c] = l[:, :, c] * alpha + p.sum(-1, keepdim=True)
                acc[:, :, c] = acc[:, :, c] * alpha + p @ v32
                m[:, :, c] = m_new
        out32 = acc / torch.clamp(l, min=1e-30)
        ctx.save_for_backward(q, k, v, out32, m + torch.log(l))
        ctx.group, ctx.q_chunk = group, q_chunk
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out32, lse = ctx.saved_tensors
        group, q_chunk = ctx.group, ctx.q_chunk
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        s_local, d = q.shape[2], q.shape[3]
        scale = 1.0 / (d ** 0.5)
        q32 = q.float() * scale
        do32 = grad_out.float()
        delta = (do32 * out32).sum(-1, keepdim=True)
        pos = torch.arange(s_local, device=q.device)
        q_pos = idx * s_local + pos
        dq = torch.zeros_like(q32)
        k_cur, v_cur = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for t in range(n):
            if t:
                k_cur, v_cur, dk, dv = _rotate((k_cur, v_cur, dk, dv), group, n, idx)
            kv_pos = (idx - t) % n * s_local + pos
            k32, v32 = k_cur.float(), v_cur.float()
            for c in _chunks(s_local, q_chunk):
                p = torch.exp(_scores(q32[:, :, c], k32, q_pos[c], kv_pos) - lse[:, :, c])
                dv += p.transpose(-1, -2) @ do32[:, :, c]
                ds = p * (do32[:, :, c] @ v32.transpose(-1, -2) - delta[:, :, c])
                dq[:, :, c] += ds @ k32
                dk += ds.transpose(-1, -2) @ q32[:, :, c]
        if n > 1:
            # The shard this rank holds after the last step started at rank
            # idx + 1: one more hop takes its dK/dV home.
            dk, dv = _rotate((dk, dv), group, n, idx)
        return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_group,
                   q_chunk: int = 0) -> torch.Tensor:
    """Causal attention of this rank's ``(batch, heads, s_local, head_dim)``
    shard of q, k and v, whose sequence is split into contiguous shards
    over ``seq_group`` in rank order; returns this rank's shard of the
    output. Exact: the full softmax, accumulated ring step by ring step.
    ``q_chunk`` > 0 must divide ``s_local``."""
    n = dist.get_world_size(seq_group)
    s_local = q.shape[2]
    if q_chunk and s_local % q_chunk:
        raise ValueError(
            f"q_chunk={q_chunk} must divide the local seq shard {s_local} "
            f"(seq {s_local * n} over {n} shards)"
        )
    return _RingAttention.apply(q, k, v, seq_group, q_chunk)
