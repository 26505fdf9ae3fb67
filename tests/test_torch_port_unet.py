"""PyTorch port: the TINY SDXL UNet against the JAX UNet.

Same weights (numpy, in the JAX layout, carried over with
``params_from_jax``) and the same numpy inputs go through both packages at
fp32. The forward bar is the JAX package's own bar for its UNet against
the torch twin (rtol 2e-4, atol 2e-5, tests/test_full_model_parity.py).
The ``fused_gn`` route (the resnets' GroupNorm + SiLU through the fused
op: JAX ``group_norm_silu``'s XLA composition, the port's NCHW entry with
its plain version and hand-written backward on the CPU) is held to the
same bars.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aozora_sdxl_training_tpu.models.sdxl import unet as jax_unet
from aozora_sdxl_training_tpu.models.sdxl.arch import TINY, param_shapes
from aozora_sdxl_training_tpu_torch.models.sdxl import unet as port_unet
from aozora_sdxl_training_tpu_torch.models.sdxl.arch import TINY as PORT_TINY
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``tests.test_torch_port_trainer.one_thread``, imported
    here when the fixture runs: that module imports this one); the JAX
    side's threads are XLA's own."""
    from tests.test_torch_port_trainer import one_thread
    with one_thread():
        yield


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(123)
    np_params = numpy_params(TINY, rng)
    b, hw = 2, 16
    inputs = (rng.normal(size=(b, hw, hw, 4)).astype(np.float32),
              np.asarray([17.0, 900.0], np.float32),
              rng.normal(size=(b, 7, TINY.cross_attention_dim)).astype(np.float32),
              rng.normal(size=(b, TINY.pooled_projection_dim)).astype(np.float32),
              np.asarray([[512, 512, 0, 0, 512, 512],
                          [768, 512, 32, 16, 704, 512]], np.float32))
    tangent = rng.normal(size=(b, hw, hw, 4)).astype(np.float32)
    return np_params, inputs, tangent


def numpy_params(cfg, rng):
    """JAX-layout params like ``init_params`` (N(0, 1/fan_in) weights), with
    biases and norm scales perturbed so mis-wired ones can't hide."""
    out = {}
    for name, (shape, kind) in sorted(param_shapes(cfg).items()):
        if name.endswith(".bias") or kind == "norm":
            base = 0.0 if name.endswith(".bias") else 1.0
            out[name] = (base + rng.normal(scale=0.05, size=shape)).astype(np.float32)
        else:
            std = (1.0 / max(int(np.prod(shape[:-1])), 1)) ** 0.5
            out[name] = (rng.normal(size=shape) * std).astype(np.float32)
    return out


def _jax_forward(np_params, inputs, attn_impl):
    fwd = jax.jit(functools.partial(
        jax_unet.unet_forward, cfg=TINY, attn_impl=attn_impl,
        compute_dtype=jnp.float32, remat=False))
    return fwd({k: jnp.asarray(v) for k, v in np_params.items()},
               *(jnp.asarray(x) for x in inputs))


def _port_forward(np_params, inputs, attn_impl, remat=False, requires_grad=False):
    params = params_from_jax(np_params)
    for p in params.values():
        p.requires_grad_(requires_grad)
    out = port_unet.unet_forward(
        params, *(torch.from_numpy(x) for x in inputs), cfg=PORT_TINY,
        attn_impl=attn_impl, compute_dtype=torch.float32, remat=remat)
    return params, out


@pytest.fixture(scope="module")
def jax_xla_forward(setup):
    np_params, inputs, _ = setup
    return np.asarray(_jax_forward(np_params, inputs, "xla"))


def test_fp32_forward_matches_jax(setup, jax_xla_forward):
    np_params, inputs, _ = setup
    _, out = _port_forward(np_params, inputs, "xla")
    assert out.shape == jax_xla_forward.shape
    np.testing.assert_allclose(out.detach().numpy(), jax_xla_forward,
                               rtol=2e-4, atol=2e-5)


def test_flash_branch_matches_jax_flash_branch(setup, monkeypatch):
    """Every attention (KV >= 1) forced through flash in both packages: the
    port's flash wrapper (its plain version on the CPU) against the JAX
    Pallas kernel in interpret mode."""
    np_params, inputs, _ = setup
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_jax_forward(np_params, inputs, "flash"))
    _, out = _port_forward(np_params, inputs, "flash")
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def jax_grads(setup):
    np_params, inputs, tangent = setup

    def loss(p):
        out = jax_unet.unet_forward(p, *(jnp.asarray(x) for x in inputs),
                                    cfg=TINY, attn_impl="xla",
                                    compute_dtype=jnp.float32, remat=False)
        return jnp.sum(out * tangent)

    grads = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in np_params.items()})
    return {k: np.asarray(v) for k, v in params_from_jax(
        {k: np.asarray(g) for k, g in grads.items()}).items()}


@pytest.mark.parametrize("remat", [False, "full"])
def test_param_gradients_match_jax_grad(setup, jax_grads, remat):
    """d sum(out * tangent) / d params against jax.grad, at fp32, with and
    without per-unit checkpointing (remat must not change gradients)."""
    np_params, inputs, tangent = setup
    want = jax_grads
    params, out = _port_forward(np_params, inputs, "xla", remat=remat,
                                requires_grad=True)
    (out * torch.from_numpy(tangent)).sum().backward()
    got = {k: p.grad.numpy() for k, p in params.items()}
    worst = 0.0
    for name in want:
        scale = max(np.abs(want[name]).max(), 1e-6)
        worst = max(worst, np.abs(got[name] - want[name]).max() / scale)
    # fp32 both sides; reductions in another order: 1e-4 of each tensor's
    # largest gradient
    assert worst < 1e-4, worst


@pytest.fixture(scope="module")
def fused_gn_runs(setup):
    """JAX's and the port's ``unet_forward(fused_gn=True)``: the output and
    d sum(out * tangent) / d params of each (one jit for JAX's pair)."""
    np_params, inputs, tangent = setup

    def loss(p):
        out = jax_unet.unet_forward(p, *(jnp.asarray(x) for x in inputs),
                                    cfg=TINY, attn_impl="xla",
                                    compute_dtype=jnp.float32, remat=False,
                                    fused_gn=True)
        return jnp.sum(out * tangent), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in np_params.items()})
    want_grads = params_from_jax({k: np.asarray(g) for k, g in grads.items()})
    params = params_from_jax(np_params)
    for p in params.values():
        p.requires_grad_(True)
    got = port_unet.unet_forward(
        params, *(torch.from_numpy(x) for x in inputs), cfg=PORT_TINY,
        attn_impl="xla", compute_dtype=torch.float32, fused_gn=True)
    (got * torch.from_numpy(tangent)).sum().backward()
    return ((got.detach().numpy(), {k: p.grad.numpy() for k, p in params.items()}),
            (np.asarray(out), {k: v.numpy() for k, v in want_grads.items()}))


@pytest.mark.parametrize("what", ["forward", "param_grads"])
def test_fused_gn_route_matches_jax(fused_gn_runs, what):
    """The port's ``unet_forward(fused_gn=True)`` against JAX's, at fp32:
    the forward at the forward bar, and every parameter's gradient at 1e-4
    of its largest magnitude (as ``test_param_gradients_match_jax_grad``)."""
    (out, grads), (want_out, want_grads) = fused_gn_runs
    if what == "forward":
        assert out.shape == want_out.shape
        np.testing.assert_allclose(out, want_out, rtol=2e-4, atol=2e-5)
        return
    assert grads.keys() == want_grads.keys()
    worst = max(np.abs(grads[k] - want_grads[k]).max()
                / max(np.abs(want_grads[k]).max(), 1e-6) for k in want_grads)
    assert worst < 1e-4, worst
