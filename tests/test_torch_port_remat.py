"""PyTorch port: the selective remat policies against the JAX package's.

* Anima "Conservative" (JAX ``make_block_fn``: keep ``mlp_down``,
  ``flash_out`` and ``flash_lse``): on the TINY head_dim-128 DiT of
  ``test_torch_port_anima_dit``, the port's gradients under Conservative
  equal its Full and Off gradients (fp32, 1e-6 of each tensor's largest
  gradient: the recompute repeats the forward's arithmetic) and JAX's
  Conservative gradients (1e-4, that file's bar for fp32 reductions in
  another order); the flash forward op runs once per block under
  Conservative and twice under Full (its CPU implementation counted).
* SDXL's ``dots``, ``dots_no_batch``, ``dots_no_logits`` and the
  ``_hires`` tiers on the TINY UNet: gradients equal the no-remat ones
  (fp32, 1e-6), the flash forward re-runs only where the policy drops its
  names, and the tiering picks the same unit modes as JAX's ``unit_remat``
  (JAX traced by ``jax.eval_shape``, no compile).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.models.sdxl import unet as jax_unet
from aozora_sdxl_training_tpu.models.sdxl.arch import TINY
from aozora_sdxl_training_tpu_torch.models.sdxl import unet as port_unet
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import params_from_jax
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port_fa
from aozora_sdxl_training_tpu_torch.ops import remat as port_remat

from tests.test_torch_port_anima_dit import (CFG, TOKENS, _port_grads, _worst,
                                             setup)  # noqa: F401  (a fixture)
from tests.test_torch_port_trainer import one_thread
from tests.test_torch_port_unet import numpy_params as unet_numpy_params


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the calls of the flash forward op's CPU implementation."""
    calls = []
    real = port_fa.flash_forward_reference

    def spy(q, *args):
        calls.append(tuple(q.shape))
        return real(q, *args)

    monkeypatch.setattr(port_fa, "flash_forward_reference", spy)
    return calls


def test_checkpoint_name_is_an_identity_the_policies_see():
    """``checkpoint_name`` returns an alias of its input (no copy), passes
    the gradient through, and the dots_no_logits policy keeps the flash
    names (and what is made inside ``producing`` them), not other names."""
    x = torch.randn(4, 3, requires_grad=True)
    y = port_remat.checkpoint_name(x * 2, "mlp_down")
    assert y.shape == x.shape and y._base is not None
    y.sum().backward()
    torch.testing.assert_close(x.grad, torch.full_like(x, 2.0))
    keep = port_remat.POLICIES["dots_no_logits"]
    name_op = torch.ops.aozora.checkpoint_name.default
    assert keep(None, name_op, x, "flash_out").name == "MUST_SAVE"
    assert keep(None, name_op, x, "mlp_down").name == "PREFER_RECOMPUTE"
    relu = torch.ops.aten.relu.default
    assert keep(None, relu, x).name == "PREFER_RECOMPUTE"
    with port_remat.producing("flash_lse"):
        assert keep(None, relu, x).name == "MUST_SAVE"


@pytest.fixture(scope="module")
def jax_conservative_grads(setup):  # noqa: F811
    np_params, inputs, tangent = setup

    def loss(p):
        latents, t, ctx, ids = (jnp.asarray(x) for x in inputs)
        from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
        out = jax_dit.dit_forward(p, latents, t, ctx, cfg=CFG, t5_ids=ids,
                                  attn_impl="xla", compute_dtype=jnp.float32,
                                  remat="conservative")
        return jnp.sum(out * tangent)

    grads = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in np_params.items()})
    from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
    return {k: v.numpy() for k, v in port_dit.params_from_jax(
        {k: np.asarray(g) for k, g in grads.items()}).items()}


def test_conservative_gradients_and_flash_runs(setup, jax_conservative_grads,  # noqa: F811
                                               flash_calls, monkeypatch):
    """Also: the down-projection's GEMM runs once a block under
    Conservative (its recompute takes the kept output), twice under Full."""
    np_params, inputs, tangent = setup
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", str(TOKENS))
    gemms = []
    real_linear = port_remat._Linear.forward

    def linear_spy(ctx, x, w, cached):
        gemms.append(cached is None)
        return real_linear(ctx, x, w, cached)

    monkeypatch.setattr(port_remat._Linear, "forward", staticmethod(linear_spy))
    got = {}
    runs = {}
    for remat in (False, True, "conservative"):
        flash_calls.clear()
        gemms.clear()
        got[remat] = _port_grads(np_params, inputs, tangent, "flash", remat)
        runs[remat] = (len(flash_calls), sum(gemms))
    n = CFG.num_blocks
    assert runs == {False: (n, n), True: (2 * n, 2 * n), "conservative": (n, n)}
    assert _worst(got["conservative"], got[False]) < 1e-6
    assert _worst(got["conservative"], got[True]) < 1e-6
    assert _worst(got["conservative"], jax_conservative_grads) < 1e-4


def test_conservative_under_sp2_names_what_jax_names(tmp_path):
    """Conservative on two gloo ranks with SP 2 (ring attention): the
    gradients of the one-process Conservative run (fp32, 1e-4 of each
    tensor's largest gradient: the ring merges partials in another order),
    and the ring's hops run again in the recompute, as under Full: JAX
    names nothing in the ring, only ``mlp_down``."""
    from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
    from tests.test_torch_port_anima_dit import numpy_params
    from tests.test_torch_port_ranks import run_task
    cfg = port_dit.TINY_ANIMA
    rng = np.random.default_rng(43)
    np_params = numpy_params(cfg, rng)
    inputs = {"latents": rng.normal(size=(1, 1, 16, 16, cfg.in_channels)).astype(np.float32),
              "t": np.asarray([0.4], np.float32),
              "ctx": rng.normal(size=(1, 12, cfg.adapter_source_dim)).astype(np.float32),
              "ids": rng.integers(1, cfg.adapter_vocab, size=(1, 12)).astype(np.int32),
              "tangent": rng.normal(size=(1, 1, 16, 16, cfg.out_channels)).astype(np.float32)}
    np.savez(tmp_path / "inputs.npz", remat="conservative", **inputs,
             **{f"p.{k}": v for k, v in np_params.items()})
    params = port_dit.params_from_jax(np_params)
    for p in params.values():
        p.requires_grad_(True)
    out = port_dit.dit_forward(
        params, *(torch.from_numpy(inputs[x]) for x in ("latents", "t", "ctx")), cfg=cfg,
        t5_ids=torch.from_numpy(inputs["ids"]), attn_impl="xla",
        compute_dtype=torch.float32, remat="conservative")
    (out * torch.from_numpy(inputs["tangent"])).sum().backward()
    want = {k: p.grad.numpy() for k, p in params.items()}
    for r, got in enumerate(run_task("dit", 2, tmp_path / "inputs.npz", tmp_path)):
        # per block, the ring's 2 hops in the forward and 2 in the recompute
        assert int(got["flash_fwd_calls"]) == 4 * cfg.num_blocks, f"rank {r}"
        assert _worst({k[2:]: v for k, v in got.items() if k.startswith("g.")},
                      want) < 1e-4, f"rank {r}"


# --------------------------------------------------------------------------
# SDXL
# --------------------------------------------------------------------------

LAT = 16          # 16 x 16 latents: TINY's units at 256 and 64 tokens


@pytest.fixture(scope="module")
def unet_case():
    rng = np.random.default_rng(41)
    np_params = unet_numpy_params(TINY, rng)
    inputs = (rng.normal(size=(1, LAT, LAT, TINY.in_channels)).astype(np.float32),
              np.asarray([321.0], np.float32),
              rng.normal(size=(1, 10, TINY.cross_attention_dim)).astype(np.float32),
              rng.normal(size=(1, TINY.pooled_projection_dim)).astype(np.float32),
              rng.normal(size=(1, 6)).astype(np.float32))
    tangent = rng.normal(size=(1, LAT, LAT, TINY.out_channels)).astype(np.float32)
    return np_params, inputs, tangent


def _unet_grads(np_params, inputs, tangent, remat, thresholds=None):
    params = params_from_jax(np_params)
    for p in params.values():
        p.requires_grad_(True)
    out = port_unet.unet_forward(params, *(torch.from_numpy(a) for a in inputs), cfg=TINY,
                                 attn_impl="flash", compute_dtype=torch.float32,
                                 remat=remat, remat_thresholds=thresholds)
    (out * torch.from_numpy(tangent)).sum().backward()
    return {k: p.grad.numpy() for k, p in params.items()}


@pytest.mark.parametrize("remat,thresholds,flash_runs", [
    (True, None, 2),
    ("dots", None, 2),                      # names are not dots: re-run
    ("dots_no_batch", None, 2),
    ("dots_no_logits", None, 1),            # saves flash_out / flash_lse
    # TINY's flash sites sit in its 64-token units
    ("dots_no_logits_hires", (100, None), 1),   # resident below 100 tokens
    ("full_hires", (100, None), 1),
    ("full_hires", (64, None), 2),
    ("dots_no_logits_hires", (16, 64), 2),      # full remat from 64 tokens
])
def test_partial_remat_gradients_equal_no_remat(unet_case, flash_calls, monkeypatch,
                                                remat, thresholds, flash_runs):
    np_params, inputs, tangent = unet_case
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", "64")
    flash_calls.clear()
    want = _unet_grads(np_params, inputs, tangent, False)
    sites = len(flash_calls)
    assert sites > 0
    flash_calls.clear()
    got = _unet_grads(np_params, inputs, tangent, remat, thresholds)
    assert _worst(got, want) < 1e-6
    assert len(flash_calls) == flash_runs * sites


@pytest.mark.parametrize("remat,thresholds,env,kinds", [
    ("dots_no_logits_hires", None, {}, 1),         # all below 4160 tokens
    ("dots_no_logits_hires", None, {"AOZORA_REMAT_HIRES_TOKENS": "100"}, 2),
    ("dots_no_logits_hires", (100, 256), {}, 2),
    ("full_hires", None, {"AOZORA_REMAT_HIRES_TOKENS": "64",
                          "AOZORA_REMAT_FULL_TOKENS": "256"}, 3),
    ("dots", None, {}, 1),
])
def test_tiers_pick_the_units_jax_picks(unet_case, monkeypatch, remat, thresholds, env,
                                        kinds):
    """The mode each resnet and transformer unit gets, in call order."""
    for key in ("AOZORA_REMAT_HIRES_TOKENS", "AOZORA_REMAT_FULL_TOKENS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    np_params, inputs, _ = unet_case
    jax_modes, port_modes = [], []
    real_jax = jax_unet._maybe_remat

    def jax_spy(fn, mode):
        jax_modes.append(mode)
        return real_jax(fn, mode)

    def port_spy(fn, mode, *args, **kwargs):
        port_modes.append(mode)
        return fn(*args, **kwargs)

    monkeypatch.setattr(jax_unet, "_maybe_remat", jax_spy)
    monkeypatch.setattr(port_unet, "remat_region", port_spy)
    jax.eval_shape(functools.partial(
        jax_unet.unet_forward, cfg=TINY, compute_dtype=jnp.float32, remat=remat,
        remat_thresholds=thresholds),
        {k: jnp.asarray(v) for k, v in np_params.items()},
        *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        port_unet.unet_forward(params_from_jax(np_params),
                               *(torch.from_numpy(a) for a in inputs), cfg=TINY,
                               compute_dtype=torch.float32, remat=remat,
                               remat_thresholds=thresholds)
    assert len(port_modes) == len(jax_modes) > 0
    assert port_modes == jax_modes
    assert len(set(map(str, port_modes))) == kinds
