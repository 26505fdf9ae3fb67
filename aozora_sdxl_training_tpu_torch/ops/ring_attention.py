"""Ring flash attention: exact attention with the token axis sharded over
the ranks of a ``torch.distributed`` group (sequence parallelism).

Counterpart of ``aozora_sdxl_training_tpu/ops/ring_attention.py``. Each
rank holds its Q/K/V token shard; the K/V shards travel the ring, one
``parallel.p2p.exchange`` per hop (send to group rank r+1, receive from
r-1; staged through pinned host memory where a gloo group carries CUDA
tensors), and each hop's partial attention, from the K5 entry points
(``flash_fwd_stats``), merges exactly through its log-sum-exp. The backward
is the JAX package's hand-built ring: with the GLOBAL (out, lse) saved from
the forward, ``flash_bwd_stats`` gives each (q shard, kv shard) pair's exact
(dq, dk, dv); dq accumulates in place while (dk, dv) travel with their kv
shard and reach home after one last hop. Merges and accumulators are fp32.

``ring_on_one_device`` runs the same hop schedule for all n ranks of a ring
in lockstep on one device, for checking the K5 entry points and the merge
at the ring's shapes where there is one card.

``sp_ring_attention`` is the island the DiT calls: it takes the global
(B, S, H, D) q, k, v that every rank of the group holds whole, slices this
rank's shard, runs the ring and all-gathers the output. Its autograd pieces
leave every rank with the whole q/k/v gradients again, so the code around it
stays replicated.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..parallel.p2p import exchange
from .flash_attention import flash_bwd_stats, flash_fwd_stats


class SPRingConfig(NamedTuple):
    """Sequence-parallel attention config, passed where a plain ``attn_impl``
    string is otherwise accepted (``models/anima/dit.py``).

    ``group`` is the sp ``ProcessGroup`` of ``axis_size`` ranks;
    ``base_impl`` is the local implementation for the attention sites that
    need no communication under SP (cross-attention to the replicated
    context, the LLM adapter)."""
    group: Any
    axis_size: int
    base_impl: str = "flash"


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def _merge(o_acc, l_acc, o_new, l_new):
    """Exact pairwise merge of two attention partials via their lse (fp32)."""
    m = torch.maximum(l_acc, l_new)
    w_acc = torch.exp(l_acc - m)
    w_new = torch.exp(l_new - m)
    denom = w_acc + w_new
    o = (o_acc * w_acc[..., None] + o_new.float() * w_new[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _hop(tensors, group):
    """Every rank sends ``tensors`` to group rank r+1 and receives the same
    shapes from r-1, in one ``parallel.p2p.exchange``."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    r = dist.get_rank(group)
    perm = _ring_perm(n)
    dst, src = dict(perm)[r], {j: i for i, j in perm}[r]
    return exchange([(t, dst) for t in tensors], [(t, src) for t in tensors], group,
                    kind="ring")


def _ring_forward(q, k, v, group, axis_size, scale):
    out, lse = flash_fwd_stats(q, k, v, scale=scale)
    o_acc, l_acc = out.float(), lse
    kk, vv = k, v
    for _ in range(axis_size - 1):
        kk, vv = _hop((kk, vv), group)
        o_s, l_s = flash_fwd_stats(q, kk, vv, scale=scale)
        o_acc, l_acc = _merge(o_acc, l_acc, o_s, l_s)
    return o_acc.to(q.dtype), l_acc


class _RingFlashAttention(torch.autograd.Function):
    """The JAX package's ``ring_flash_attention`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, group, axis_size, scale):
        out, lse = _ring_forward(q, k, v, group, axis_size, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.axis_size, ctx.scale = group, axis_size, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        kk, vv = k, v
        dq = None
        dk_ring = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_ring = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(ctx.axis_size):
            if step:
                # dk/dv accumulators travel WITH their kv shard: each rank
                # adds its q rows' contribution as the shard passes through
                kk, vv, dk_ring, dv_ring = _hop((kk, vv, dk_ring, dv_ring), group)
            dq_s, dk_s, dv_s = flash_bwd_stats(q, kk, vv, out, lse, do, scale=scale)
            dq = dq_s.float() if dq is None else dq + dq_s
            dk_ring = dk_ring + dk_s
            dv_ring = dv_ring + dv_s
        # after axis_size-1 rotations each kv shard sits one hop short of
        # home; one more hop delivers the fully accumulated (dk, dv)
        dk_ring, dv_ring = _hop((dk_ring, dv_ring), group)
        return (dq.to(q.dtype), dk_ring.to(k.dtype), dv_ring.to(v.dtype),
                None, None, None)


def ring_flash_attention(q, k, v, group, axis_size: int,
                         scale: float | None = None):
    """q, k, v: this rank's (B, S_local, H, D) token shards; S_global =
    S_local * axis_size, shards in group-rank order."""
    return _RingFlashAttention.apply(q, k, v, group, axis_size, scale)


def _all_gather_tokens(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


class _TokenShard(torch.autograd.Function):
    """This rank's token shard of a replicated (B, S, H, D) tensor. Backward:
    all-gather the shard gradients, so every rank holds the whole gradient
    of the replicated tensor."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group = group
        s = x.shape[1] // size
        return x[:, rank * s:(rank + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_tokens(g, ctx.group), None, None, None


class _TokenGather(torch.autograd.Function):
    """All-gather of the token shards into the replicated (B, S, H, D)
    tensor. Backward: the upstream gradient is the same on every rank (the
    code after the gather is replicated), so each rank takes its own slice,
    without a sum."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.s = rank, x.shape[1]
        return _all_gather_tokens(x, group)

    @staticmethod
    def backward(ctx, g):
        s = ctx.s
        return g[:, ctx.rank * s:(ctx.rank + 1) * s].contiguous(), None, None


def sp_ring_attention(q, k, v, sp: SPRingConfig, *, scale: float | None = None):
    """Ring attention over ``sp.group``: q, k, v are the GLOBAL (B, S, H, D)
    tensors, identical on every rank of the group; returns the global
    output, identical on every rank."""
    n = sp.axis_size
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"sequence parallelism: {q.shape[1]} query and "
                         f"{k.shape[1]} key tokens do not split over sp={n}")
    rank = dist.get_rank(sp.group)
    shards = [_TokenShard.apply(t, sp.group, rank, n) for t in (q, k, v)]
    out = ring_flash_attention(*shards, sp.group, n, scale)
    return _TokenGather.apply(out, sp.group, rank)


def ring_on_one_device(q, k, v, do, n: int, *, scale: float | None = None):
    """What n ranks of the ring compute, on one device: q, k, v, do are the
    GLOBAL (B, S, H, D) tensors, cut into n token shards. At hop h rank r
    holds kv shard (r - h) mod n, as in ``_RingFlashAttention``; each (dk,
    dv) shard sums its ranks' contributions in the order its accumulator
    meets them on the ring. Returns (out, lse (B, S, H) fp32, dq, dk, dv)
    for the global tensors; no autograd."""
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"ring: {q.shape[1]} query and {k.shape[1]} key "
                         f"tokens do not split over {n} shards")
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(n, dim=1)]
                       for t in (q, k, v, do))
    outs, lses = [], []
    for r in range(n):
        o_acc, l_acc = flash_fwd_stats(qs[r], ks[r], vs[r], scale=scale)
        o_acc = o_acc.float()
        for hop in range(1, n):
            j = (r - hop) % n
            o_acc, l_acc = _merge(o_acc, l_acc,
                                  *flash_fwd_stats(qs[r], ks[j], vs[j], scale=scale))
        outs.append(o_acc.to(q.dtype))
        lses.append(l_acc)
    dqs = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in qs]
    dks = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in ks]
    dvs = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in vs]
    for step in range(n):
        for r in range(n):
            j = (r - step) % n
            dq_s, dk_s, dv_s = flash_bwd_stats(qs[r], ks[j], vs[j], outs[r], lses[r],
                                               dos[r], scale=scale)
            dqs[r] += dq_s
            dks[j] += dk_s
            dvs[j] += dv_s
    return (torch.cat(outs, 1), torch.cat(lses, 1), torch.cat(dqs, 1).to(q.dtype),
            torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype))
