"""PyTorch port: the Anima DiT against the JAX DiT.

Same weights (numpy, in the JAX layout, carried over with
``params_from_jax``) and the same numpy inputs go through both packages at
fp32. The config is a TINY DiT whose head_dim is 128 (``TINY_ANIMA``'s is
24), so the self-attention can take the head_dim-128 flash path of both
packages: the port's flash wrapper (its plain version on the CPU) against
the JAX folded Pallas kernel in interpret mode. The forward bar is the one
the port's UNet test uses (rtol 2e-4, atol 2e-5); gradients are held at
1e-4 of each tensor's largest gradient (fp32, reductions in another order).
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port_fa

CFG = replace(jax_dit.TINY_ANIMA, model_channels=256, num_heads=2,
              num_blocks=2)
PORT_CFG = replace(port_dit.TINY_ANIMA, model_channels=256, num_heads=2,
                   num_blocks=2)
# 15 x 14 latents: circular padding to 16 x 14, then 8 x 7 = 56 tokens
B, H, W, LS = 2, 15, 14, 12
TOKENS = 56


def numpy_params(cfg, rng):
    """JAX-layout params like ``init_params`` (N(0, 1/fan_in) matrices), with
    biases and 1-D scales perturbed so mis-wired ones can't hide."""
    out = {}
    for name, shape in sorted(jax_dit.param_shapes(cfg).items()):
        if len(shape) == 1:
            base = 0.0 if name.endswith(".bias") else 1.0
            out[name] = (base + rng.normal(scale=0.05, size=shape)).astype(np.float32)
        else:
            out[name] = (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    np_params = numpy_params(CFG, rng)
    inputs = (rng.normal(size=(B, 1, H, W, CFG.in_channels)).astype(np.float32),
              np.asarray([0.031, 0.87], np.float32),
              rng.normal(size=(B, LS, CFG.adapter_source_dim)).astype(np.float32),
              rng.integers(1, CFG.adapter_vocab, size=(B, LS)).astype(np.int32))
    tangent = rng.normal(size=(B, 1, H, W, CFG.out_channels)).astype(np.float32)
    return np_params, inputs, tangent


def _jax_forward(params, inputs, attn_impl):
    latents, t, ctx, ids = (jnp.asarray(x) for x in inputs)
    return jax_dit.dit_forward(params, latents, t, ctx, cfg=CFG, t5_ids=ids,
                               attn_impl=attn_impl, compute_dtype=jnp.float32,
                               remat=False)


def _port_forward(np_params, inputs, attn_impl, remat=False, requires_grad=False):
    params = port_dit.params_from_jax(np_params)
    for p in params.values():
        p.requires_grad_(requires_grad)
    latents, t, ctx, ids = (torch.from_numpy(x) for x in inputs)
    out = port_dit.dit_forward(params, latents, t, ctx, cfg=PORT_CFG, t5_ids=ids,
                               attn_impl=attn_impl, compute_dtype=torch.float32,
                               remat=remat)
    return params, out


@pytest.fixture(scope="module")
def jax_xla_forward(setup):
    np_params, inputs, _ = setup
    fwd = jax.jit(functools.partial(_jax_forward, attn_impl="xla"))
    return np.asarray(fwd({k: jnp.asarray(v) for k, v in np_params.items()}, inputs))


def test_fp32_forward_matches_jax(setup, jax_xla_forward):
    np_params, inputs, _ = setup
    _, out = _port_forward(np_params, inputs, "xla")
    assert out.shape == jax_xla_forward.shape == (B, 1, H, W, CFG.out_channels)
    np.testing.assert_allclose(out.detach().numpy(), jax_xla_forward,
                               rtol=2e-4, atol=2e-5)


def test_flash_path_matches_jax_flash_path(setup, monkeypatch):
    """Self-attention (KV 56, head_dim 128) forced through flash in both
    packages; the cross-attention and adapter (KV 16 and 12) stay on einsum.
    The port's flash entry is reached once per block."""
    np_params, inputs, _ = setup
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", str(TOKENS))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_jax_forward(
            {k: jnp.asarray(v) for k, v in np_params.items()}, inputs, "flash"))
    calls = []
    real = port_fa.FlashAttention.apply

    def spy(q, *args):
        calls.append(tuple(q.shape))
        return real(q, *args)

    monkeypatch.setattr(port_fa.FlashAttention, "apply", spy)
    _, out = _port_forward(np_params, inputs, "flash")
    assert calls == [(B, TOKENS, CFG.num_heads, 128)] * CFG.num_blocks
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def jax_grads(setup):
    np_params, inputs, tangent = setup

    def loss(p):
        return jnp.sum(_jax_forward(p, inputs, "xla") * tangent)

    grads = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in np_params.items()})
    return {k: v.numpy() for k, v in port_dit.params_from_jax(
        {k: np.asarray(g) for k, g in grads.items()}).items()}


def _port_grads(np_params, inputs, tangent, attn_impl, remat):
    params, out = _port_forward(np_params, inputs, attn_impl, remat=remat,
                                requires_grad=True)
    (out * torch.from_numpy(tangent)).sum().backward()
    return {k: p.grad.numpy() for k, p in params.items()}


def _worst(got, want):
    assert got.keys() == want.keys()
    return max(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-6)
               for k in want)


@pytest.mark.parametrize("remat", [False, "full"])
def test_param_gradients_match_jax_grad(setup, jax_grads, remat):
    """d sum(out * tangent) / d params against jax.grad, at fp32, with and
    without per-block checkpointing; the adapter's parameters are in it."""
    np_params, inputs, tangent = setup
    got = _port_grads(np_params, inputs, tangent, "xla", remat)
    assert np.abs(got["llm_adapter.embed.weight"]).max() > 0
    assert _worst(got, jax_grads) < 1e-4


def test_flash_gradients_and_remat_full_equal_off(setup, jax_grads, monkeypatch):
    """Through the flash path the gradients match jax.grad too, and Full
    remat gives the Off gradients (the recompute repeats the forward)."""
    np_params, inputs, tangent = setup
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", str(TOKENS))
    off = _port_grads(np_params, inputs, tangent, "flash", False)
    full = _port_grads(np_params, inputs, tangent, "flash", "full")
    assert _worst(full, off) < 1e-6
    assert _worst(off, jax_grads) < 1e-4


def test_adapter_matches_jax(setup):
    """The LLM adapter alone, and the pad to context_tokens around it."""
    np_params, inputs, _ = setup
    _, _, ctx, ids = inputs
    want = jax_dit.preprocess_text_embeds(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(ctx),
        jnp.asarray(ids), CFG)
    got = port_dit.preprocess_text_embeds(
        port_dit.params_from_jax(np_params), torch.from_numpy(ctx),
        torch.from_numpy(ids), PORT_CFG)
    assert got.shape == (B, CFG.context_tokens, CFG.adapter_target_dim)
    assert float(got[:, LS:].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_params_round_trip_between_packages(setup):
    """params_from_jax, the port's torch-layout checkpoint state and the JAX
    package's checkpoint loader agree, both ways, bit for bit."""
    np_params, _, _ = setup
    port = port_dit.params_from_jax(np_params)
    state = {k: v.numpy() for k, v in port_dit.params_to_torch_state(port).items()}
    back = jax_dit.params_from_torch_state(state, CFG)
    assert back.keys() == np_params.keys()
    for name, want in np_params.items():
        np.testing.assert_array_equal(np.asarray(back[name]), want, err_msg=name)
    jax_state = {k: np.asarray(v) for k, v in jax_dit.params_to_torch_state(
        {k: jnp.asarray(v) for k, v in np_params.items()}).items()}
    loaded = port_dit.params_from_torch_state(jax_state, PORT_CFG)
    for name, t in loaded.items():
        np.testing.assert_array_equal(t.numpy(), port[name].numpy(), err_msg=name)
    assert {k: tuple(v.shape) for k, v in loaded.items()} == \
        port_dit.param_shapes(PORT_CFG)


def test_anima_base_shapes_match_jax():
    """ANIMA_BASE: the port's torch-layout shapes are the JAX package's
    transposed, 2.09 B parameters, head_dim 128."""
    jax_shapes = jax_dit.param_shapes(jax_dit.ANIMA_BASE)
    port_shapes = port_dit.param_shapes(port_dit.ANIMA_BASE)
    assert port_shapes.keys() == jax_shapes.keys()
    for name, shape in jax_shapes.items():
        want = shape[::-1] if len(shape) == 2 and not name.endswith("embed.weight") \
            else shape
        assert port_shapes[name] == want, name
    n = sum(int(np.prod(s)) for s in port_shapes.values())
    assert 2.08e9 < n < 2.10e9 and port_dit.ANIMA_BASE.head_dim == 128
