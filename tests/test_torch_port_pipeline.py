"""PyTorch port: GPipe pipeline parallelism (``parallel/pipeline.py``) against
the JAX package's.

* ``split/merge_block_params``, ``stackify/unstackify_params`` and
  ``split_stacked`` on the TINY Anima params (4 blocks): the same keys,
  shapes and values as the JAX functions', and the same refusal of
  non-uniform trainability; ``params_from_jax`` carries the JAX package's
  stacked params into the port's layout.
* ``pp_dit_forward`` of the port on gloo ranks (fresh interpreters without
  JAX, ``tests/test_torch_port_ranks.py``'s ``pipeline`` task) against the
  JAX function on a (dp=1, pp=2) mesh of the 8 virtual CPU devices, fp32:
  the output and every parameter's gradient (of sum(out * tangent)) to
  1e-4, and FSDP's global norm of those gradients; once on 2 ranks (pp 2)
  for an image batch (Full remat) and a 5-D clip batch (T=2, Conservative
  remat), and once on 4 ranks as dp 2 x pp 2, FSDP sharding the tensors
  around the stack over dp (threshold lowered to 1024 elements for TINY).
  The inputs are made from a seed with numpy; the JAX side runs remat-free
  (remat does not change the values).
* The same ranks then take one int8 AdamW step on their stage slices with
  those gradients and write the training state, which JAX's loader reads:
  its ``__stack__.`` keys and shapes and every leaf's int8 decision (made
  on the whole stacked leaf) are JAX's, and for three stacked leaves the
  codes and scales equal JAX's quantizers' on the whole leaf's moments,
  bit for bit. With ``min_8bit_size`` 64 the stacked q-norm leaf (4 x 24
  elements) is int8, and the two stages share its one block, whose scale
  they merge.
* The int8 quantizer on parts of a tensor that start inside a block, with
  a merge of the parts' block maxima, equals the JAX quantizer on the
  whole tensor.
* A training state written by the JAX package's saver for a pp run loads
  into the port's stages, each taking its blocks' moments.
"""

import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aozora_sdxl_training_tpu.ckpt import train_state as jax_state
from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.opt import adamw as jax_adamw
from aozora_sdxl_training_tpu.parallel import pipeline as jax_pl
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.opt import adamw as port_adamw
from aozora_sdxl_training_tpu_torch.parallel import pipeline as port_pl

from tests.test_torch_port_ranks import finish, start, world_env

CFG4 = replace(jax_dit.TINY_ANIMA, num_blocks=4)
PORT_CFG4 = replace(port_dit.TINY_ANIMA, num_blocks=4)
MIN8 = 64          # the int8 step's min_8bit_size
FSDP_MIN = 1024    # the dp x pp run's FSDP threshold
# case: (batch, latent frames, microbatches, the port's remat)
CASES = {"img": (2, 1, 2, "full"), "vid": (2, 2, 2, "conservative")}


def _jax_params():
    return {k: np.asarray(v) for k, v in
            jax_dit.init_params(CFG4, jax.random.PRNGKey(0)).items()}


def _inputs(rng, b, t):
    return {"latents": rng.standard_normal((b, t, 6, 6, CFG4.in_channels)).astype(np.float32),
            "t": np.linspace(100.0, 900.0, b).astype(np.float32) / 1000.0,
            "ctx": rng.standard_normal((b, 8, CFG4.adapter_source_dim)).astype(np.float32),
            "ids": np.tile(np.arange(1, 9, dtype=np.int32)[None], (b, 1)),
            "tangent": rng.standard_normal(
                (b, t, 6, 6, CFG4.out_channels)).astype(np.float32)}


def _jax_case(params, inp, micro):
    """JAX's pp_dit_forward on a (1, 2) mesh: (out, flat grads of sum(out *
    tangent) in the JAX layout)."""
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "pp"))
    stacked, rest = jax_pl.split_block_params(
        {k: jnp.asarray(v) for k, v in params.items()}, CFG4.num_blocks)
    stacked = {k: jax.device_put(v, NamedSharding(mesh, P("pp"))) for k, v in stacked.items()}
    rest = {k: jax.device_put(v, NamedSharding(mesh, P())) for k, v in rest.items()}
    args = [jax.device_put(jnp.asarray(inp[k]), NamedSharding(mesh, P("dp")))
            for k in ("latents", "t", "ctx", "ids", "tangent")]

    def loss(s, r, lat, ts, ctx, ids, tangent):
        out = jax_pl.pp_dit_forward(s, r, lat, ts, ctx, cfg=CFG4, mesh=mesh,
                                    microbatches=micro, t5_ids=ids,
                                    compute_dtype=jnp.float32, remat=False)
        return jnp.sum(out * tangent), out

    (_, out), (g_s, g_r) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        stacked, rest, *args)
    grads = jax_pl.merge_block_params(g_s, g_r, CFG4.num_blocks)
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Starts the port's ranks (2 for pp 2, 4 for dp 2 x pp 2), computes
    the JAX side meanwhile, and returns (JAX results, the ranks' arrays,
    the JAX params, work dir)."""
    root = tmp_path_factory.mktemp("port_pipeline")
    params = _jax_params()
    rng = np.random.default_rng(11)
    data = {c: _inputs(rng, b, t) for c, (b, t, _, _) in CASES.items()}
    runs = {"pp2": (1, 2, list(CASES)), "dp2pp2": (2, 2, ["img"])}
    procs, names = [], []
    for name, (dp, pp, cases) in runs.items():
        arrays = {"dp": dp, "pp": pp, "min": FSDP_MIN, "min8": MIN8, "cases": np.array(cases),
                  **{f"p.{k}": v for k, v in params.items()}}
        for c in cases:
            _, _, micro, remat = CASES[c]
            arrays.update({f"{c}.{k}": v for k, v in data[c].items()})
            arrays.update({f"{c}.micro": micro // dp, f"{c}.remat": remat,
                           f"{c}.state": str(root / f"{name}_{c}_state.safetensors"),
                           f"{c}.cfg.num_blocks": CFG4.num_blocks})
        np.savez(root / f"{name}.npz", **arrays)
        cmd = [sys.executable, "-m", "tests.test_torch_port_ranks", "pipeline",
               str(root / f"{name}.npz"), str(root / name)]
        procs += start([cmd] * (dp * pp), root, env=world_env(dp * pp, root / f"{name}_store"))
        names.append((name, dp * pp))
    want = {c: _jax_case(params, data[c], CASES[c][2]) for c in CASES}
    results = finish(procs, timeout=300)
    for i, (code, out, err) in enumerate(results):
        assert code == 0, f"rank process {i} exited {code}:\n{out}\n{err}"
    got = {name: [dict(np.load(root / f"{name}_{r}.npz")) for r in range(n)]
           for name, n in names}
    return want, got, params, data, root


def _port_layout(grads: dict) -> dict:
    return {k: port_dit.from_jax_layout(k, torch.from_numpy(v)).numpy() for k, v in grads.items()}


@pytest.mark.parametrize("run,case", [("pp2", "img"), ("pp2", "vid"), ("dp2pp2", "img")])
def test_pp_forward_and_gradients_match_jax(world, run, case):
    want, got, _, data, _ = world
    out_w, grads_w = want[case]
    ranks = got[run]
    dp = max(int(r["dp_rank"]) for r in ranks) + 1
    # every stage holds the same output: the dp ranks' rows in order
    outs = [np.concatenate([r[f"{case}.out"] for r in ranks if int(r["pp_rank"]) == s])
            for s in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], out_w, rtol=1e-4, atol=1e-4)
    grads_w = _port_layout(grads_w)
    scale = max(float(np.abs(v).max()) for v in grads_w.values())
    for r in ranks:
        for k, w in grads_w.items():
            np.testing.assert_allclose(r[f"{case}.g.{k}"], w, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=f"{run} {case} {k}")
        norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in grads_w.values()))
        assert float(r[f"{case}.norm"]) == pytest.approx(norm, rel=1e-5)
        # each stage holds half the blocks; a micro step's hops: M forward
        # sends from stage 0, M backward sends from stage 1, one microbatch each
        stacked = sum(v.size for k, v in grads_w.items() if k.startswith("blocks."))
        assert int(r[f"{case}.stage_elements"]) == stacked // 2
        micro = CASES[case][2] // dp
        mb = data[case]["latents"].shape[0] // dp // micro
        b, t = mb, data[case]["latents"].shape[1]
        assert int(r[f"{case}.hops"]) == 2 * micro
        assert int(r[f"{case}.hop_bytes"]) == micro * b * t * 3 * 3 * CFG4.model_channels * 4


# the leaves whose int8 codes are held against JAX's quantizers: the q-norm's
# (24 elements a block, so int8 only stacked, and its one block straddles
# the two stages), an AdaLN down-projection's and the MLP's
CODED = ("__stack__.self_attn.q_norm.weight", "__stack__.adaln_modulation_mlp.1.weight",
         "__stack__.mlp.layer1.weight")


@pytest.mark.parametrize("run,case", [("pp2", "img"), ("dp2pp2", "img")])
def test_pp_int8_state_matches_jax(world, run, case):
    """One int8 step from zero moments with the gathered gradients: the
    port's state file, read by JAX's loader, has JAX's stacked keys and
    shapes, JAX's int8 decision for every leaf (on the whole stacked
    leaf's size), and, for the ``CODED`` leaves, JAX's quantizers' codes
    and scales of the step's moments (g (1 - beta1) and g^2 (1 - beta2):
    the update's arithmetic from zero moments) on the whole leaf."""
    _, got, params, _, root = world
    grads = {k[len(case) + 3:]: v for k, v in got[run][0].items()
             if k.startswith(f"{case}.g.")}
    grads_jax = jax_pl.stackify_params(
        {k: port_dit.to_jax_layout(k, torch.from_numpy(v)).contiguous().numpy()
         for k, v in grads.items()}, CFG4.num_blocks)
    want = jax_pl.stackify_params(params, CFG4.num_blocks)
    cfg = jax_adamw.AdamWConfig(momentum_dtype="int8_blockwise", min_8bit_size=MIN8)
    meta, state = jax_state.load_train_state(root / f"{run}_{case}_state.safetensors")
    assert state.step == 1 and meta["global_step"] == 1
    assert set(state.exp_avg) == set(state.exp_avg_sq) == set(want)
    beta1, beta2 = cfg.betas
    for k, w in want.items():
        for field in (state.exp_avg, state.exp_avg_sq):
            held = field[k]
            assert isinstance(held, tuple) == cfg.int8_for(w.size), k
            assert (held[0] if isinstance(held, tuple) else held).shape == w.shape, k
        if k in CODED:
            g = jnp.asarray(grads_jax[k])
            for held, (codes, scales) in (
                    (state.exp_avg[k], jax_adamw.quantize_moment_int8(g * (1.0 - beta1))),
                    (state.exp_avg_sq[k],
                     jax_adamw.quantize_second_moment_int8(g * g * (1.0 - beta2)))):
                np.testing.assert_array_equal(held[0], np.asarray(codes), err_msg=k)
                np.testing.assert_array_equal(held[1], np.asarray(scales), err_msg=k)
    assert not cfg.int8_for(PORT_CFG4.head_dim) and cfg.int8_for(4 * PORT_CFG4.head_dim)


# --------------------------------------------------------------------------
# stacking, on one process
# --------------------------------------------------------------------------

def test_stacking_matches_jax():
    """The port's stacking of the TINY params (the JAX package's numpy
    params carried into the port's layout) equals the JAX package's
    stacking carried across: keys, shapes and values; and back."""
    params = _jax_params()
    want_s, want_r = jax_pl.split_block_params(params, CFG4.num_blocks)
    port = port_dit.params_from_jax(params)
    got_s, got_r = port_pl.split_block_params(port, CFG4.num_blocks)
    assert sorted(got_s) == sorted(want_s) and sorted(got_r) == sorted(want_r)
    stk_w = jax_pl.stackify_params(params, CFG4.num_blocks)
    stk_g = port_pl.stackify_params(port, CFG4.num_blocks)
    assert list(stk_g) == list(stk_w)
    carried = port_dit.params_from_jax({k: np.asarray(v) for k, v in stk_w.items()})
    for k, v in stk_g.items():
        assert tuple(v.shape) == tuple(carried[k].shape), k
        torch.testing.assert_close(v, carried[k], rtol=0, atol=0)
    s, r = port_pl.split_stacked(stk_g)
    assert sorted(s) == sorted(want_s) and set(r) == set(want_r)
    back = port_pl.unstackify_params(stk_g, CFG4.num_blocks)
    assert set(back) == set(port)
    for k, v in port.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    merged = port_pl.merge_block_params(got_s, got_r, CFG4.num_blocks)
    assert set(merged) == set(port)
    # numpy params stack as the JAX package's do
    np_s, _ = port_pl.split_block_params(params, CFG4.num_blocks)
    for k, v in np_s.items():
        np.testing.assert_array_equal(v, np.asarray(want_s[k]))
    assert port_pl.unstackify_params(port, CFG4.num_blocks) == port


def test_stackify_refuses_non_uniform_blocks():
    params = {"blocks.0.w": np.ones((2, 2)), "blocks.1.w": np.ones((2, 2)),
              "blocks.0.only_here": np.ones((2,)), "other": np.ones((3,))}
    with pytest.raises(ValueError) as want:
        jax_pl.stackify_params(params, 2)
    with pytest.raises(ValueError) as got:
        port_pl.stackify_params({k: torch.from_numpy(v) for k, v in params.items()}, 2)
    assert str(got.value) == str(want.value)
    assert "block-uniform" in str(got.value)


def test_int8_parts_quantize_as_the_whole():
    """A tensor cut into parts that start inside blocks (as pipeline stages
    cut a stacked leaf): each part's codes and its blocks' scales, with the
    parts' maxima merged, are the JAX quantizer's on the whole tensor."""
    rng = np.random.default_rng(3)
    whole = (rng.standard_normal(1000) * np.exp(rng.standard_normal(1000))).astype(np.float32)
    codes_w, scales_w = (np.asarray(x) for x in jax_adamw.quantize_moment_int8(jnp.asarray(whole)))
    cuts = [0, 300, 520, 1000]
    amax = np.zeros(4, np.float32)
    for a, b in zip(cuts, cuts[1:]):
        for i in range(a, b):
            amax[i // 256] = max(amax[i // 256], abs(whole[i]))
    for a, b in zip(cuts, cuts[1:]):
        b0 = a // 256

        def merge(part_amax, b0=b0):
            return torch.from_numpy(amax[b0:b0 + part_amax.numel()].copy())
        codes, scales = port_adamw.quantize_moment_int8(torch.from_numpy(whole[a:b]), a % 256,
                                                        merge)
        np.testing.assert_array_equal(codes.numpy(), codes_w[a:b])
        np.testing.assert_array_equal(scales.numpy(), scales_w[b0:b0 + scales.numel()])
        back = port_adamw.dequantize_moment_int8(codes, scales, a % 256)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jax_adamw.dequantize_moment_int8(
                jnp.asarray(codes_w), jnp.asarray(scales_w)))[a:b])


def test_jax_pp_state_loads_into_the_stages(tmp_path):
    """A training state that the JAX package's saver writes for a pp run
    (its ``__stack__.`` moments in the JAX layout; int8 codes and scales
    over each whole leaf, made here by the port's quantizer, which other
    tests hold to JAX's, and fp32 for the leaves under ``min_8bit_size``)
    is read by the port's loader and cut into each stage's slices
    (``FSDP.shard_state``; the layout needs no process group): a stage's
    float moments are the leaf's blocks of that stage in the port's layout,
    its codes and scales that stage's part of the leaf's, and
    ``restored_state`` takes them for the stage's parameters."""
    from aozora_sdxl_training_tpu_torch.ckpt.train_state import load_train_state
    from aozora_sdxl_training_tpu_torch.parallel import sharding
    stacked = jax_pl.stackify_params(_jax_params(), CFG4.num_blocks)
    cfg = port_adamw.AdamWConfig(momentum_dtype="int8_blockwise", min_8bit_size=MIN8)
    rng = np.random.default_rng(8)
    moments = []
    for _ in range(2):
        field = {}
        for k, v in stacked.items():
            x = rng.standard_normal(v.shape).astype(np.float32)
            field[k] = (tuple(t.numpy() for t in port_adamw.quantize_moment_int8(
                torch.from_numpy(x))) if cfg.int8_for(x.size) else x)
        moments.append(field)
    jax_state.save_train_state(
        tmp_path / "state.safetensors", global_step=3, micro_step=3,
        opt_state=jax_adamw.AdamWState(np.int32(3), *moments), sampler_seed=0,
        sampler_epoch=0, timestep_sampler_state=None)
    layout = port_adamw.Layout(port_dit.to_jax_layout, port_dit.from_jax_layout)
    _, host = load_train_state(tmp_path / "state.safetensors", layout)
    port_params = port_pl.stackify_params(
        port_dit.params_from_jax(_jax_params()), CFG4.num_blocks)
    straddled = 0
    for r in range(2):
        mesh = sharding.Mesh(1, 1, 0, 0, None, None, 2, r, None)
        params = {k: v.clone() for k, v in port_params.items()}
        fsdp = sharding.FSDP(mesh, {k: tuple(v.shape) for k, v in params.items()},
                             layout, torch.float32)
        fsdp.shard_params(params)
        state = port_adamw.restored_state(fsdp.shard_state(host), params, cfg)
        assert state.step == 3
        for field, want in zip((state.exp_avg, state.exp_avg_sq), moments):
            for k, w in want.items():
                got = field[k]
                if k not in fsdp.stages:
                    continue
                spec = fsdp.stages[k]
                blocks = slice(spec.first, spec.first + spec.blocks)
                if isinstance(w, tuple):
                    b0 = spec.offset // 256
                    nb = -(-(spec.offset % 256 + spec.size) // 256)
                    np.testing.assert_array_equal(got[0].numpy(), w[0][blocks], err_msg=k)
                    np.testing.assert_array_equal(got[1].numpy(), w[1][b0:b0 + nb], err_msg=k)
                    straddled += spec.offset % 256 != 0
                else:
                    np.testing.assert_array_equal(
                        got.numpy(),
                        port_dit.from_jax_layout(k, torch.from_numpy(w)).numpy()[blocks],
                        err_msg=k)
    assert straddled > 0
