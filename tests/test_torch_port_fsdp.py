"""PyTorch port: FSDP (``parallel/sharding.FSDP``) against the JAX package.

* The port shards exactly the tensors that the JAX package's
  ``param_partition_spec`` (``mode="fsdp"``, 2^16 elements) gives a spec
  other than ``P()``: every tensor of the TINY SDXL UNet and the TINY
  Anima DiT, at dp 2, 4 and 8 (pure calls, no ranks).
* On 2 gloo ranks (``tests/test_torch_port_ranks.py``, task ``fsdp``):
  each sharded tensor gathered from its shards is the tensor, bit for bit;
  the reduce-scatter (buckets far smaller than a tensor, and larger) and
  the sync of a step give every tensor the sum of the ranks' gradients;
  the global norm counts each replicated tensor once.
* On 4 ranks, dp 2 x sp 2: the step's reduction equals what the port's
  per-tensor ``all_reduce_grads(params, sp)`` gave before FSDP (the sum
  over every rank, divided by sp).
* The int8 moments: an AdamW update of each rank's shard (dp 2, 4, 8)
  equals the whole tensor's update bit for bit, codes, scales and weights
  (the shards cut the JAX layout's flat order at whole 256-element blocks).

Tolerances: the gathers are exact; the reductions add in another order
than numpy's sum, so they hold at rtol 1e-6 (fp32).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.models.sdxl import arch as jax_arch
from aozora_sdxl_training_tpu.parallel import sharding as jax_shard
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import (
    from_jax_layout, to_jax_layout)
from aozora_sdxl_training_tpu_torch.opt import adamw
from aozora_sdxl_training_tpu_torch.parallel import sharding as port_shard

from tests.test_torch_port_ranks import run_task

SDXL_LAYOUT = adamw.Layout(to_jax_layout, from_jax_layout)
DIT_LAYOUT = adamw.Layout(port_dit.to_jax_layout, port_dit.from_jax_layout)


def _fsdp(shapes, layout, dp, rank=0, **kw):
    """An FSDP of rank ``rank`` of dp over ``shapes`` (port layout), without
    process groups: its layout alone."""
    mesh = port_shard.Mesh(dp, 1, rank, 0, None, None)
    return port_shard.FSDP(mesh, shapes, layout, torch.float32, **kw)


def _port_shapes(jax_shapes: dict, layout) -> dict:
    return {n: tuple(layout.from_jax(n, torch.empty(s, device="meta")).shape)
            for n, s in jax_shapes.items()}


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("model", ["sdxl", "anima"])
def test_shard_decisions_match_param_partition_spec(model, dp):
    if model == "sdxl":
        jax_shapes = {n: s for n, (s, _) in jax_arch.param_shapes(jax_arch.TINY).items()}
        layout = SDXL_LAYOUT
    else:
        cfg = replace(jax_dit.TINY_ANIMA, in_channels=4, out_channels=4, adapter_vocab=128)
        jax_shapes = jax_dit.param_shapes(cfg)
        layout = DIT_LAYOUT
    want = {n for n, s in jax_shapes.items()
            if jax_shard.param_partition_spec(tuple(s), dp) != jax_shard.P()}
    fsdp = _fsdp(_port_shapes(jax_shapes, layout), layout, dp)
    assert set(fsdp.specs) == want
    for n, s in jax_shapes.items():
        assert port_shard.shards_over_dp(s, dp) == (n in want)
    if model == "sdxl":
        assert len(want) >= 30          # TINY's widest convs and GEGLU weights
    for n, spec in fsdp.specs.items():
        assert spec.jax_shape == tuple(jax_shapes[n])
        assert spec.size % adamw.INT8_BLOCK == 0 and spec.size * dp >= spec.numel
        assert spec.size * dp - spec.numel < dp * adamw.INT8_BLOCK


def _inputs(tmp_path, ranks, dp, sp, bucket):
    """Tensors in the port's layout (a conv, linears, a bias; one with no
    axis that 2 divides stays replicated), and a gradient per rank."""
    rng = np.random.default_rng(dp * 10 + sp)
    shapes = {"down.conv.weight": (8, 6, 3, 3), "ff.proj.weight": (40, 12),
              "ff.out.weight": (12, 20), "norm.bias": (40,), "odd.weight": (7, 9)}
    arrays = {"dp": dp, "sp": sp, "min": 64, "bucket": bucket}
    for name, shape in shapes.items():
        arrays[f"full.{name}"] = rng.normal(size=shape).astype(np.float32)
        arrays[f"grad.{name}"] = rng.normal(size=(ranks, *shape)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **arrays)
    return arrays, shapes


@pytest.mark.parametrize("bucket", [64, 1 << 20])
def test_gather_reduce_scatter_and_norm_on_two_ranks(tmp_path, bucket):
    arrays, shapes = _inputs(tmp_path, 2, 2, 1, bucket)
    ranks = run_task("fsdp", 2, tmp_path / "inputs.npz", tmp_path, timeout=120)
    sharded = {"down.conv.weight", "ff.proj.weight", "ff.out.weight"}
    want_sq = 0.0
    for r, got in enumerate(ranks):
        assert set(got["sharded"]) == sharded
        # each rank: its half, padded to whole 256-element blocks
        assert list(got["held"]) == [256, 256, 256]
        for name in shapes:
            if name in sharded:
                np.testing.assert_array_equal(got[f"gathered.{name}"], arrays[f"full.{name}"])
            total = arrays[f"grad.{name}"].sum(axis=0)
            np.testing.assert_allclose(got[f"reduced.{name}"], total, rtol=1e-6, atol=1e-6)
            if r == 0:
                want_sq += float((total.astype(np.float64) ** 2).sum())
    for got in ranks:
        assert float(got["norm"]) == pytest.approx(want_sq ** 0.5, rel=1e-6)


def test_dp_sp_reduction_matches_all_reduce_grads_on_four_ranks(tmp_path):
    """dp 2 x sp 2: the shards reduce-scatter over dp and average over sp,
    the replicated tensors sum over the world and divide by sp: what
    ``all_reduce_grads(params, sp)`` (a sum over every rank, then / sp)
    gave every tensor."""
    arrays, shapes = _inputs(tmp_path, 4, 2, 2, 1 << 20)
    ranks = run_task("fsdp", 4, tmp_path / "inputs.npz", tmp_path, timeout=120)
    for got in ranks:
        assert set(got["sharded"]) == {"down.conv.weight", "ff.proj.weight", "ff.out.weight"}
        for name in shapes:
            want = arrays[f"grad.{name}"].sum(axis=0) / 2
            np.testing.assert_allclose(got[f"reduced.{name}"], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_sharded_int8_update_equals_whole_tensor_update(dp):
    """Three AdamW steps with int8 moments on a conv whose element count
    is not a multiple of 256, once whole and once as dp shards: every
    rank's codes, scales and weights are the whole tensor's, bit for bit."""
    name, shape = "mid.conv.weight", (88, 41, 3, 3)       # 32,472 elements
    cfg = adamw.AdamWConfig(momentum_dtype="int8_blockwise", min_8bit_size=4096,
                            weight_decay=0.01, debias_strength=0.3)
    rng = np.random.default_rng(dp)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 10.0 ** -k)
             for k in range(3)]
    whole = {name: w.clone()}
    state = adamw.init_state(whole, cfg, SDXL_LAYOUT)
    shards = [_fsdp({name: shape}, SDXL_LAYOUT, dp, rank=r, min_elements=4096)
              for r in range(dp)]
    parts = [{name: f.shard(name, w)} for f in shards]
    states = [adamw.init_state(p, cfg, f.opt_layout()) for p, f in zip(parts, shards)]
    assert all(isinstance(s.exp_avg[name], tuple) for s in states)
    for step, g in enumerate(grads):
        adamw.apply_updates(whole, {name: g}, state, cfg, lr=1e-3)
        for f, p, s in zip(shards, parts, states):
            adamw.apply_updates(p, {name: f.shard(name, g)}, s, cfg, lr=1e-3)
    n_blocks = -(-w.numel() // adamw.INT8_BLOCK)
    for f, p, s in zip(shards, parts, states):
        torch.testing.assert_close(p[name], f.shard(name, whole[name]), rtol=0, atol=0)
        for mine, full in ((s.exp_avg[name], state.exp_avg[name]),
                           (s.exp_avg_sq[name], state.exp_avg_sq[name])):
            codes, scales = f.shard_int8(name, *full)
            assert torch.equal(mine[0], codes)
            per = f.specs[name].size // adamw.INT8_BLOCK
            real = max(0, min(per, n_blocks - f.rank * per))
            assert torch.equal(mine[1][:real], scales[:real])
