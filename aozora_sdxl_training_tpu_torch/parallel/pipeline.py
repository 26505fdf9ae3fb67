"""Pipeline parallelism (GPipe) for the Anima DiT block stack.

Counterpart of ``aozora_sdxl_training_tpu/parallel/pipeline.py``, with its
names and messages. The DiT's identical blocks are split into ``pp``
contiguous stages, one per rank of the mesh's pp group, and microbatches
stream through the stages GPipe-style:

* block parameters are **stage-stacked**: every ``blocks.{i}.<suffix>``
  tensor family becomes one ``__stack__.<suffix>`` leaf of shape
  ``[num_blocks, ...]`` (``stackify_params``), of which each rank holds
  only its own stage's ``[num_blocks // pp, ...]`` slice
  (``parallel/sharding.FSDP`` keeps the slices);
* the schedule runs ``M + pp - 1`` ticks; at tick t, stage r runs
  microbatch t - r through its blocks (bubble ticks skip the compute),
  stage 0 takes a fresh microbatch, the last stage collects the outputs,
  and each activation hops to the next stage (non-cyclic: stage 0
  receives nothing) through ``parallel/p2p.exchange``;
* the collected outputs are replicated over the pp group (the JAX
  package's ``where`` to the last stage and ``psum``), so the prologue and
  epilogue of the DiT run replicated on every stage.

JAX gets the backward schedule from ``jax.grad`` through the scan and the
``ppermute``; here it is written out (``_GPipe``): the forward keeps each
microbatch's stage inputs and the graph of its stage output (under the
block remat, which keeps only what its policy names), and the backward
runs the ticks in reverse, the gradient of each stage input hopping to
the stage before. The cotangents are those of the JAX package's
``shard_map`` transpose: only the last stage feeds d(output) into its
blocks, once (every rank holds the same d(output), the code after the
pipeline being replicated); d(emb), d(context) and d(lora), read by every
stage, are summed over the pp group; d(x) comes from stage 0's injection
alone (the others add zeros); the RoPE tables take no gradient. Each
stage's block weights get their gradients on the stage that holds them.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.distributed as dist

from .p2p import exchange

BLOCK_RE = re.compile(r"blocks\.(\d+)\.(.+)$")


def _stack(leaves):
    return torch.stack(leaves) if isinstance(leaves[0], torch.Tensor) else np.stack(leaves)


def split_block_params(params: dict, num_blocks: int):
    """Flat param dict -> (stacked {suffix: [L, ...]}, rest flat dict).
    Tensors stack with ``torch.stack``, numpy arrays (the JAX package's
    params on the host) with ``np.stack``."""
    rest = {k: v for k, v in params.items() if not BLOCK_RE.match(k)}
    suffixes = sorted({m.group(2) for k in params
                       if (m := BLOCK_RE.match(k))})
    stacked = {s: _stack([params[f"blocks.{i}.{s}"]
                          for i in range(num_blocks)]) for s in suffixes}
    return stacked, rest


def merge_block_params(stacked: dict, rest: dict, num_blocks: int) -> dict:
    """Inverse of :func:`split_block_params`."""
    out = dict(rest)
    for s, leaf in stacked.items():
        for i in range(num_blocks):
            out[f"blocks.{i}.{s}"] = leaf[i]
    return out


class _Schedule:
    """What the pipeline's autograd function needs beside its tensors."""

    def __init__(self, mesh, block_fn, names, rope, microbatches: int, per_stage: int):
        self.group, self.pp, self.rank = mesh.pp_group, mesh.pp, mesh.pp_rank
        self.block_fn, self.names, self.rope = block_fn, names, rope
        self.microbatches, self.per_stage = microbatches, per_stage
        self.like = None                    # one microbatch's activation

    def stage(self, weights, x, e, c, lo):
        """This rank's blocks on one microbatch."""
        for i in range(self.per_stage):
            pdict = {f"blk.{s}": leaf[i] for s, leaf in zip(self.names, weights)}
            x = self.block_fn(pdict, "blk", x, e, c, self.rope, lo)
        return x

    def hop(self, tick: int, out, step: int):
        """Tick ``tick``'s hop, ``step`` +1 in the forward and -1 in the
        backward: ``out`` (None on a bubble tick) goes to stage rank +
        step, and what stage rank - step sent comes in (it sent when it was
        active: its microbatch tick - (rank - step) lies in range). The
        hop is non-cyclic: the first stage of each direction receives
        nothing. Returns what came in, or None."""
        r, src, dst = self.rank, self.rank - step, self.rank + step
        sends = [(out, dst)] if out is not None and 0 <= dst < self.pp else []
        recv = 0 <= src < self.pp and 0 <= tick - src < self.microbatches
        got = exchange(sends, [(self.like, src)] if recv else [], self.group,
                       kind="pipeline")
        return got[0] if recv else None


class _GPipe(torch.autograd.Function):
    """The stage stack over the pp group: the forward ticks, then the
    backward ticks in reverse (the module docstring gives the cotangents).
    Inputs: the schedule, x, emb, context, lora and this stage's stacked
    weights."""

    @staticmethod
    def forward(ctx, sched, x, emb, context, lora, *weights):
        m_count, pp, r = sched.microbatches, sched.pp, sched.rank
        b = x.shape[0]
        if b % m_count:
            raise ValueError(
                f"per-dp-shard batch {b} not divisible by "
                f"microbatches={m_count}")
        need = ctx.needs_input_grad
        ins = [t.chunk(m_count) for t in (x, emb, context, lora)]
        sched.like = ins[0][0]
        leaves = [w.detach().requires_grad_(need[5 + j]) for j, w in enumerate(weights)]
        kept, outs, buf = {}, [None] * m_count, None
        for t in range(m_count + pp - 1):
            m = t - r
            y = None
            if 0 <= m < m_count:
                with torch.enable_grad():
                    # stage 0 takes a fresh microbatch, the others what came in
                    x_in = (ins[0][m] if r == 0 else buf).detach().requires_grad_(True)
                    e, c, lo = (ins[k][m].detach().requires_grad_(need[1 + k])
                                for k in (1, 2, 3))
                    y = sched.stage(leaves, x_in, e, c, lo)
                kept[m] = ((x_in, e, c, lo), y)
                y = y.detach()
                if r == pp - 1:
                    outs[m] = y
            buf = sched.hop(t, y, +1)
        ctx.sched, ctx.kept, ctx.leaves = sched, kept, leaves
        ctx.likes = [(t.shape, t.dtype) for t in (x, emb, context, lora)]
        out = torch.cat(outs) if r == pp - 1 else torch.zeros_like(x)
        if pp > 1:
            # the collected outputs, replicated over the pp group
            dist.all_reduce(out, group=sched.group)
        return out

    @staticmethod
    def backward(ctx, d_out):
        sched, kept, leaves = ctx.sched, ctx.kept, ctx.leaves
        m_count, pp, r = sched.microbatches, sched.pp, sched.rank
        dys = d_out.chunk(m_count)
        d_in = [[None] * m_count for _ in range(4)]       # x, emb, context, lora
        d_w = [None] * len(leaves)
        wanted = [j for j, w in enumerate(leaves) if w.requires_grad]
        buf = None
        for t in reversed(range(m_count + pp - 1)):
            m = t - r
            dx = None
            if 0 <= m < m_count:
                inputs, y = kept.pop(m)
                which = [k for k in range(4) if inputs[k].requires_grad]
                # only the last stage feeds d(output) in, once
                grads = torch.autograd.grad(
                    y, [inputs[k] for k in which] + [leaves[j] for j in wanted],
                    dys[m] if r == pp - 1 else buf, allow_unused=True)
                for k, g in zip(which, grads):
                    d_in[k][m] = g
                for j, g in zip(wanted, grads[len(which):]):
                    if g is not None:
                        d_w[j] = g if d_w[j] is None else d_w[j] + g
                dx = d_in[0][m]
            buf = sched.hop(t, dx, -1)
        ctx.kept = ctx.leaves = None
        need = ctx.needs_input_grad
        out = []
        for k, (shape, dtype) in enumerate(ctx.likes):
            if not need[1 + k]:
                out.append(None)
                continue
            # d(x) is stage 0's injection alone: the other stages add zeros
            parts = d_in[k] if k or r == 0 else [None] * m_count
            g = torch.cat([p if p is not None else torch.zeros(
                (shape[0] // m_count, *shape[1:]), dtype=dtype, device=d_out.device)
                for p in parts])
            if pp > 1:
                dist.all_reduce(g, group=sched.group)
            out.append(g)
        return (None, *out, *d_w)


def pipeline_blocks(stacked: dict, x: torch.Tensor, emb: torch.Tensor,
                    context: torch.Tensor, rope, lora, *, mesh,
                    block_fn, num_blocks: int, microbatches: int):
    """Run the DiT block stack pipelined over the mesh's pp group.

    stacked: {suffix: [num_blocks // pp, ...]}, this rank's stage.
    x: (B, T, H, W, D) activations, this dp rank's batch.
    emb/lora: (B, T, d'); context: (B, Lc, Dc): per-sample conditioning,
    microbatched alongside x. rope: (cos, sin), the same on every stage.
    block_fn: ``models.anima.dit.make_block_fn(...)``'s result.
    Returns the stack's output, the same on every rank of the pp group."""
    pp = int(mesh.pp)
    if num_blocks % pp:
        raise ValueError(f"num_blocks={num_blocks} not divisible by pp={pp}")
    per_stage = num_blocks // pp
    names = sorted(stacked)
    for s in names:
        if stacked[s].shape[0] != per_stage:
            raise ValueError(f"stacked leaf {s} holds {stacked[s].shape[0]} blocks; "
                             f"stage {mesh.pp_rank} of pp={pp} holds {per_stage}")
    sched = _Schedule(mesh, block_fn, names, rope, int(microbatches), per_stage)
    return _GPipe.apply(sched, x, emb, context, lora, *(stacked[s] for s in names))


def pp_dit_forward(stacked: dict, rest: dict, latents, timesteps, context,
                   *, cfg, mesh, microbatches: int,
                   t5_ids=None, attn_impl="xla",
                   compute_dtype=torch.bfloat16, remat=True):
    """Full Anima DiT forward with the block stack pipeline-parallel.

    ``stacked``/``rest`` come from :func:`split_stacked` (``stacked``
    holding this rank's stage); the prologue (patchify/embedders/LLM
    adapter) and the epilogue (final AdaLN + unpatchify) run replicated on
    every stage, and only the block stack streams through the pp group."""
    from ..models.anima import dit

    x, emb, ctx, rope, lora, orig = dit.dit_prologue(
        rest, latents, timesteps, context, cfg=cfg, t5_ids=t5_ids,
        attn_impl=attn_impl, compute_dtype=compute_dtype)
    block_fn = dit.make_block_fn(cfg, attn_impl, remat)
    x = pipeline_blocks(stacked, x, emb, ctx, rope, lora, mesh=mesh,
                        block_fn=block_fn, num_blocks=cfg.num_blocks,
                        microbatches=microbatches)
    return dit.dit_epilogue(rest, x, emb, lora, orig, cfg=cfg,
                            compute_dtype=compute_dtype)


# --------------------------------------------------------------------------
# Trainer integration: stacked params living inside an ordinary flat dict
# --------------------------------------------------------------------------

STACK_PREFIX = "__stack__."


class PPConfig:
    """Pipeline-parallel run settings threaded into the loss function:
    ``mesh`` is the run's ``parallel.sharding.Mesh`` (its pp group)."""

    def __init__(self, mesh, microbatches: int):
        self.mesh = mesh
        self.microbatches = int(microbatches)


def stackify_params(params: dict, num_blocks: int) -> dict:
    """Flat dict -> flat dict where every ``blocks.{i}.<suffix>`` family
    becomes one ``__stack__.<suffix>`` leaf of shape ``[num_blocks, ...]``.

    The stacked layout keeps the optimizer, the gradient accumulation and
    the training-state file oblivious to pipeline parallelism (they see
    ordinary name->tensor dicts); only the loss function and the sharding
    special-case the prefix. Every suffix must be present for every block
    (freezing must be block-uniform), otherwise this raises."""
    block_names = [k for k in params if BLOCK_RE.match(k)]
    per_suffix: dict[str, int] = {}
    for k in block_names:
        per_suffix.setdefault(BLOCK_RE.match(k).group(2), 0)
        per_suffix[BLOCK_RE.match(k).group(2)] += 1
    bad = {s: n for s, n in per_suffix.items() if n != num_blocks}
    if bad:
        raise ValueError(
            "pipeline parallelism needs block-uniform trainability; these "
            f"suffixes are not present for all {num_blocks} blocks: "
            f"{sorted(bad)} (adjust the trained-keywords filter)")
    stacked, rest = split_block_params(params, num_blocks)
    return {**{STACK_PREFIX + s: v for s, v in stacked.items()}, **rest}


def unstackify_params(params: dict, num_blocks: int) -> dict:
    """Inverse of :func:`stackify_params` (no-op without stacked keys)."""
    stacked = {k[len(STACK_PREFIX):]: v for k, v in params.items()
               if k.startswith(STACK_PREFIX)}
    rest = {k: v for k, v in params.items()
            if not k.startswith(STACK_PREFIX)}
    if not stacked:
        return rest
    return merge_block_params(stacked, rest, num_blocks)


def split_stacked(params: dict):
    """{__stack__.s: v, rest...} -> (stacked {s: v}, rest)."""
    stacked = {k[len(STACK_PREFIX):]: v for k, v in params.items()
               if k.startswith(STACK_PREFIX)}
    rest = {k: v for k, v in params.items()
            if not k.startswith(STACK_PREFIX)}
    return stacked, rest
