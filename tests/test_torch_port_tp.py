"""PyTorch port: tensor parallelism's layout, without ranks.

* ``parallel/sharding.py``'s ``tp_param_spec`` is the JAX package's word for
  word, and FSDP's tp decisions (taken on the port's shapes through the
  model's JAX layout) are the JAX function's on its own shape tables, for
  every SDXL_BASE and ANIMA_BASE tensor at tp 2, 3, 4 and 8;
* cutting every tensor of a TINY model into its tp slices
  (``FSDP.tp_slice``, one fake rank at a time) and joining them back gives
  the whole tensor, in the port's layout and in the JAX package's, and the
  GEGLU projection's slices hold h and gate each cut by tp;
* int8 blockwise quantization of a tp slice of a moment, with the block
  maxima merged over the fake ranks, gives the whole tensor's codes and
  scales bit for bit (column slices, the GEGLU halves and row slices whose
  blocks straddle the ranks);
* a GEGLU projection whose halves tp does not divide is refused by name,
  and the registry the tp collectives find their group in keeps no
  ``TPConfig`` alive.
"""

import gc
import math

import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.models.sdxl import arch as jax_arch
from aozora_sdxl_training_tpu.parallel import sharding as jax_shard
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.models.sdxl import conversion
from aozora_sdxl_training_tpu_torch.opt import adamw
from aozora_sdxl_training_tpu_torch.parallel import sharding, tensor_parallel as tpm

LAYOUTS = {"sdxl": adamw.Layout(conversion.to_jax_layout, conversion.from_jax_layout),
           "anima": adamw.Layout(port_dit.to_jax_layout, port_dit.from_jax_layout)}


def _shapes(model: str, tiny: bool = False) -> tuple:
    """(port shapes, JAX shapes) of a model's tensors."""
    if model == "sdxl":
        cfg = jax_arch.TINY if tiny else jax_arch.SDXL_BASE
        return (conversion.torch_param_shapes(cfg),
                {n: s for n, (s, _) in jax_arch.param_shapes(cfg).items()})
    cfg = port_dit.TINY_ANIMA if tiny else port_dit.ANIMA_BASE
    jax_cfg = jax_dit.TINY_ANIMA if tiny else jax_dit.ANIMA_BASE
    return port_dit.param_shapes(cfg), jax_dit.param_shapes(jax_cfg)


def _fsdp(model: str, shapes: dict, tp: int, rank: int = 0) -> sharding.FSDP:
    """FSDP's layout at dp 1 x tp, seen from tp rank ``rank`` (no process
    group: the layout needs none)."""
    mesh = sharding.Mesh(1, 1, 0, 0, None, None, tp=tp, tp_rank=rank)
    return sharding.FSDP(mesh, shapes, LAYOUTS[model], torch.float32)


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
@pytest.mark.parametrize("model", ["sdxl", "anima"])
def test_tp_decisions_match_jax(model, tp):
    port_shapes, jax_shapes = _shapes(model)
    assert port_shapes.keys() == jax_shapes.keys()
    want = {}
    for name, shape in jax_shapes.items():
        spec = jax_shard.tp_param_spec(name, tuple(shape), tp)
        assert sharding.tp_param_spec(name, tuple(shape), tp) == spec, name
        if spec is not None:
            want[name] = tuple(spec).index("tp")
    fsdp = _fsdp(model, port_shapes, tp)
    assert {n: s.jax_axis for n, s in fsdp.tps.items()} == want
    for name, spec in fsdp.tps.items():
        assert spec.jax_shape == tuple(jax_shapes[name]) and name not in fsdp.specs
    if tp in (2, 4, 8):
        # the JAX rules split the same tensors at every tp dividing the widths
        count, elements = {"sdxl": (770, 2_184_652_800),
                           "anima": (346, 1_862_295_552)}[model]
        assert (len(fsdp.tps), sum(s.numel for s in fsdp.tps.values())) == (count, elements)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", ["sdxl", "anima"])
def test_cut_and_join_give_the_jax_layout(model, tp):
    port_shapes, _ = _shapes(model, tiny=True)
    layout = LAYOUTS[model]
    gen = torch.Generator().manual_seed(3)
    ranks = [_fsdp(model, port_shapes, tp, r) for r in range(tp)]
    assert ranks[0].tps
    for name, spec in ranks[0].tps.items():
        whole = torch.randn(spec.shape, generator=gen)
        parts = [f.tp_slice(name, whole) for f in ranks]
        assert all(p.numel() * tp == whole.numel() for p in parts)
        assert torch.equal(tpm.join(parts, spec.axis, spec.parts), whole), name
        jax_whole = layout.to_jax(name, whole)
        jax_parts = [f.tp_slice(name, jax_whole, jax=True) for f in ranks]
        assert all(torch.equal(layout.to_jax(name, p), q) for p, q in zip(parts, jax_parts))
        assert torch.equal(tpm.join(jax_parts, spec.jax_axis, spec.parts), jax_whole), name
    geglu = [n for n in ranks[0].tps if n.endswith(".ff.net.0.proj.weight")]
    assert geglu and model == "sdxl" or not geglu
    for name in geglu:
        whole = torch.randn(port_shapes[name], generator=gen)
        h, gate = whole.chunk(2, dim=0)
        for r, f in enumerate(ranks):
            assert torch.equal(f.tp_slice(name, whole),
                               torch.cat([h.chunk(tp)[r], gate.chunk(tp)[r]]))


@pytest.mark.parametrize("second", [False, True], ids=["first", "second"])
@pytest.mark.parametrize("name,shape", [
    # (out, in) in the port's layout: column slices of an (in, out) JAX
    # matrix straddle its 256-element blocks; the GEGLU's are two pieces a
    # rank; the row slices split at an element inside a block
    ("a.attn1.to_q.weight", (40, 24)),
    ("a.ff.net.0.proj.weight", (96, 20)),
    ("a.ff.net.2.weight", (20, 54)),
    ("b.mlp.0.bias", (264,)),
])
def test_int8_of_a_tp_slice_is_the_whole_tensors(name, shape, second):
    tp = 2
    layout = LAYOUTS["sdxl"]
    fsdp = [_fsdp("sdxl", {name: shape}, tp, r) for r in range(tp)]
    spec = fsdp[0].tps[name]
    gen = torch.Generator().manual_seed(11)
    whole = torch.randn(shape, generator=gen) * torch.rand(shape, generator=gen) ** 4
    if second:
        whole = whole ** 2
    quantize = adamw.quantize_second_moment_int8 if second else adamw.quantize_moment_int8
    dequantize = (adamw.dequantize_second_moment_int8 if second
                  else adamw.dequantize_moment_int8)
    want_codes, want_scales = quantize(layout.to_jax(name, whole))
    blocks = math.ceil(spec.numel / adamw.INT8_BLOCK)
    ids = [tpm.block_ids(spec, tp, r, adamw.INT8_BLOCK, "cpu") for r in range(tp)]
    parts = [layout.to_jax(name, f.tp_slice(name, whole)) for f in fsdp]
    part_amax = []          # each rank's block maxima, as the quantizer takes them
    for i, p in zip(ids, parts):
        quantize(p, spread=(i, blocks, lambda a: part_amax.append(a) or a))
    merged = torch.stack(part_amax).amax(0)
    assert any(not torch.equal(a, merged) for a in part_amax)   # the merge matters
    codes = []
    for r, part in enumerate(parts):
        got_codes, got_scales = quantize(part, spread=(ids[r], blocks, lambda a: merged))
        assert torch.equal(got_scales, want_scales)
        codes.append(got_codes)
        np.testing.assert_array_equal(
            dequantize(got_codes, got_scales, spread=(ids[r], blocks, None)).numpy(),
            fsdp[r].tp_slice(name, dequantize(want_codes, want_scales), jax=True).numpy())
    assert torch.equal(tpm.join(codes, spec.jax_axis, spec.parts), want_codes)


def test_geglu_halves_that_tp_does_not_divide_are_refused():
    """tp 4 divides the projection's 12 columns (JAX splits it) but not
    each half's 6."""
    name = "a.ff.net.0.proj.weight"
    assert sharding.tp_param_spec(name, (8, 12), 4) is not None
    with pytest.raises(ValueError, match=r"a\.ff\.net\.0\.proj\.weight.*each half's 6"):
        tpm.spec_for(name, (12, 8), (8, 12), 1, 4)
    assert tpm.spec_for(name, (16, 8), (8, 16), 1, 4).parts == 2


def test_tp_configs_are_not_kept_alive_by_the_registry():
    config = tpm.TPConfig(None, 2, 0)
    key = config.key
    assert tpm._GROUPS[key] is config
    del config
    gc.collect()
    assert key not in tpm._GROUPS
