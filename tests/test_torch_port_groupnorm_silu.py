"""PyTorch port: the fused GroupNorm + SiLU op (K6) against the JAX package.

The port's ``group_norm_silu`` on CPU tensors (its plain version: the CUDA
kernel runs only on the card, ``tests/test_torch_port_cuda.py``) against
JAX ``group_norm_silu(..., use_pallas=True)``, whose Pallas kernel runs in
interpret mode on the CPU as ``tests/test_groupnorm_silu.py`` runs it, and
``use_pallas=False`` (the XLA composition). Forward and the gradients of x,
scale and bias (the plain ``_fused_bwd`` in both), NHWC, in fp32 and bf16,
including the SDXL UNet's narrowest width (C=320, 32 groups of 10
channels) at a small, ragged HW. The NCHW entry (``group_norm_silu_nchw``,
the UNet's ``fused_gn`` route) is held against JAX ``group_norm_silu`` on
the transposed inputs, and the NCHW kernel's launch plan (cluster size,
slices, what shared memory holds) is checked at every SDXL_BASE resnet
shape.

Tolerances: fp32 2e-4 (relative and absolute) for the output, rtol 1e-3
and atol 2e-4 for the gradients (the same math, sums in another order);
bf16 2% of the largest magnitude (one bf16 rounding of the output and of
x's gradient, at different places in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.ops import groupnorm_silu as jax_gn
from aozora_sdxl_training_tpu_torch.ops import groupnorm_silu as port_gn
from aozora_sdxl_training_tpu_torch.tools.k6_probe import forward_sites

from tests.test_torch_port_trainer import one_thread


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


# (B, H, W, C), groups
SHAPES = [((2, 8, 8, 32), 8), ((1, 5, 7, 320), 32), ((2, 4, 4, 64), 32)]
DTYPES = {"fp32": (np.float32, torch.float32, jnp.float32),
          "bf16": (None, torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (mean + rng.normal(size=shape)).astype(np.float32)
    scale = (1.0 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.2 * rng.normal(size=(c,))).astype(np.float32)
    tangent = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, tangent


def _close(got, want, dtype_name, grad=False, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype_name == "fp32":
        tol = dict(rtol=1e-3, atol=2e-4) if grad else dict(rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, want, err_msg=err_msg, **tol)
    else:
        err = np.abs(got - want).max()
        assert err <= 2e-2 * np.abs(want).max(), f"{err_msg}: {err}"


def _port(x, scale, bias, tangent, groups, dtype, use_pallas=True):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    out = port_gn.group_norm_silu(xt, st, bt, groups=groups, use_pallas=use_pallas)
    (out.float() * torch.from_numpy(tangent)).sum().backward()
    return out.detach().float().numpy(), xt.grad.float().numpy(), st.grad.numpy(), bt.grad.numpy()


def _jax(x, scale, bias, tangent, groups, dtype, use_pallas):
    def loss(xj, s, b):
        out = jax_gn.group_norm_silu(xj, s, b, groups=groups, use_pallas=use_pallas)
        return jnp.sum(out.astype(jnp.float32) * tangent), out

    grads, out = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x).astype(dtype), jnp.asarray(scale), jnp.asarray(bias))
    return (np.asarray(out.astype(jnp.float32)),
            *(np.asarray(g.astype(jnp.float32)) for g in grads))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_op_matches_jax(shape, groups, dtype_name, use_pallas):
    """The port's op (fused forward, plain on the CPU) against JAX's fused
    op (interpreted Pallas) and its XLA composition, forward and gradients;
    ``use_pallas=False`` in the port is the plain composition."""
    _, tdtype, jdtype = DTYPES[dtype_name]
    x, scale, bias, tangent = _inputs(shape, sum(shape))
    got = _port(x, scale, bias, tangent, groups, tdtype, use_pallas=use_pallas)
    want = _jax(x, scale, bias, tangent, groups, jdtype, use_pallas)
    for name, a, w in zip(("out", "dx", "dscale", "dbias"), got, want):
        _close(a, w, dtype_name, grad=name != "out", err_msg=name)


@pytest.mark.parametrize("shape,groups", SHAPES[:2])
def test_fused_and_plain_paths_agree_in_the_port(shape, groups):
    """Both routes of the port give the same output and gradients on the
    CPU (fp32, 1e-5: the autograd and the hand-written backward sum
    in another order), and neither counts a kernel launch there."""
    x, scale, bias, tangent = _inputs(shape, 7)
    before = dict(port_gn.LAUNCHES)
    fused = _port(x, scale, bias, tangent, groups, torch.float32, use_pallas=True)
    plain = _port(x, scale, bias, tangent, groups, torch.float32, use_pallas=None)
    for a, b in zip(fused, plain):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert port_gn.LAUNCHES == before


def test_large_mean_matches_a_float64_reference():
    """x with mean 300 and unit spread: the port's statistics (two-pass in
    fp32) hold the float64 answer to 2e-3 of the output's magnitude, where
    a single-pass E[x^2] - mean^2 in fp32 would lose the variance."""
    x, scale, bias, _ = _inputs((1, 8, 8, 64), 3, mean=300.0)
    got = port_gn.group_norm_silu_reference(torch.from_numpy(x), torch.from_numpy(scale),
                                            torch.from_numpy(bias), 32).numpy()
    xd = x.astype(np.float64).reshape(1, 64, 32, 2)
    y = ((xd - xd.mean(axis=(1, 3), keepdims=True))
         / np.sqrt(xd.var(axis=(1, 3), keepdims=True) + 1e-5)).reshape(x.shape)
    y = y * scale + bias
    want = y / (1 + np.exp(-y))
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


def test_wrapper_rejects_what_the_kernel_does_not_take_before_any_launch():
    """The checks that guard the CUDA launch (run here on the CPU by
    calling them directly): rank, groups, dtype, contiguity, scale/bias."""
    x = torch.zeros(1, 4, 4, 32)
    s = torch.ones(32)
    with pytest.raises(ValueError, match="expected"):
        port_gn._check_cuda_inputs(x[0], s, s, 8)
    with pytest.raises(ValueError, match="groups"):
        port_gn._check_cuda_inputs(x, s, s, 5)
    with pytest.raises(TypeError, match="dtype"):
        port_gn._check_cuda_inputs(x.double(), s, s, 8)
    with pytest.raises(ValueError, match="contiguous"):
        port_gn._check_cuda_inputs(x.permute(0, 2, 1, 3), s, s, 8)
    with pytest.raises(ValueError, match="scale"):
        port_gn._check_cuda_inputs(x, s[:16], s, 8)
    port_gn._check_cuda_inputs(x, s, s, 8)


def test_rows_per_chunk_covers_any_length():
    """A site spreads over at most 256 NHWC statistics blocks, at least one
    row each."""
    assert port_gn.rows_per_chunk(128 * 128) == 64
    assert port_gn.rows_per_chunk(32 * 32) == 4
    assert port_gn.rows_per_chunk(30) == 1
    assert port_gn.rows_per_chunk(37 * 53) == 8


def _to_nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape,groups", SHAPES[:2])
def test_nchw_op_matches_jax_on_the_transposed_inputs(shape, groups, dtype_name):
    """The NCHW entry with use_pallas=True (its plain version on the CPU,
    the NCHW ``_fused_bwd`` counterpart as its backward) against JAX's
    ``group_norm_silu`` on the same values in NHWC: output and the
    gradients of x, scale and bias, transposed back; no launch counted."""
    _, tdtype, jdtype = DTYPES[dtype_name]
    x, scale, bias, tangent = _inputs(shape, sum(shape) + 1)
    before = dict(port_gn.LAUNCHES)
    xt = torch.from_numpy(_to_nchw(x)).to(tdtype).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    out = port_gn.group_norm_silu_nchw(xt, st, bt, groups=groups, use_pallas=True)
    assert out.shape == xt.shape and out.dtype == tdtype and out.is_contiguous()
    (out.float() * torch.from_numpy(_to_nchw(tangent))).sum().backward()
    assert xt.grad.shape == xt.shape
    got = (out.detach().float().numpy(), xt.grad.float().numpy(), st.grad.numpy(),
           bt.grad.numpy())
    want = _jax(x, scale, bias, tangent, groups, jdtype, None)
    want = (_to_nchw(want[0]), _to_nchw(want[1]), *want[2:])
    for name, a, w in zip(("out", "dx", "dscale", "dbias"), got, want):
        _close(a, w, dtype_name, grad=name != "out", err_msg=name)
    assert port_gn.LAUNCHES == before


@pytest.mark.parametrize("elem,vec", [(2, True), (4, True), (2, False)])
def test_nchw_plan_covers_every_span(elem, vec):
    """At every SDXL_BASE site shape (B=1 and 2) and at odd shapes, the
    NCHW plan's slices cover the (batch, group) span, are whole 16-byte
    vectors on the vector route, never leave a CTA empty, and what shared
    memory holds fits a CTA; either the whole slice is held or the card
    (here the plan's model of 132 SMs) holds every cluster at once; at B=1
    the CTAs nearly cover the card's 132 SMs."""
    sites = forward_sites()
    assert len(sites) == 34
    v = 16 // elem if vec else 1
    shapes = ([(b, c, side * side, 32) for side, c in set(sites) for b in (1, 2)]
              + [(2, 640, 37 * 56, 32), (1, 320, 8 * 8, 32), (1, 48, 16 * 16, 12),
                 (3, 64, 4, 8), (1, 2560, 256 * 256, 1)])
    for b, c, hw, groups in shapes:
        cpg = c // groups
        span = cpg * hw
        csize, slice_, cached = port_gn.nchw_plan(b, c, hw, groups, elem, vec)
        label = (b, c, hw, groups)
        assert 1 <= csize <= port_gn.MAX_CLUSTER, label
        assert slice_ % v == 0 and cached % v == 0, label
        assert slice_ * csize >= span > slice_ * (csize - 1), label
        assert 0 < cached <= slice_, label
        assert cached * elem + 8 * cpg <= port_gn.NCHW_SMEM_LIMIT, label
        whole = min(slice_, (port_gn.NCHW_SMEM_LIMIT - 8 * cpg) // elem // v * v)
        held = 132 // csize * min(4, 233472 // (cached * elem + 8 * cpg + 2048))
        assert cached == whole or b * groups <= held, label
        if groups == 32 and hw >= 32 * 32:
            assert b * groups * csize >= 64, label


def test_nchw_plan_holds_every_cluster_at_once_where_the_card_can():
    """The widest bf16 span of the forward (128x128x960): 8 CTAs of 123 KB.
    By the plan's model two sit on an SM once 112 KB of each are held; where
    the runtime counts fewer clusters (30 at two a SM, as clusters of 8 fit
    120 of an H100's 132 SMs), the plan goes to three a SM."""
    assert port_gn.nchw_plan(1, 960, 128 * 128, 32, 2, True) == (8, 61440, 57224)

    def runtime(csize, cached):
        return 15 * min(4, 233472 // (cached * 2 + 8 * 30 + 2048))

    assert port_gn.nchw_plan(1, 960, 128 * 128, 32, 2, True,
                             clusters_held=runtime) == (8, 61440, 37768)
    # a span that fits whole keeps it whole
    assert port_gn.nchw_plan(1, 640, 32 * 32, 32, 2, True, clusters_held=runtime) == (
        2, 10240, 10240)


def test_nchw_wrapper_rejects_what_the_kernel_does_not_take_before_any_launch():
    """The NCHW entry's checks (run here on the CPU by calling them
    directly): rank, groups, dtype, contiguity (a channels-last tensor is
    refused), scale/bias against C = x.shape[1]."""
    x = torch.zeros(1, 32, 4, 4)
    s = torch.ones(32)
    with pytest.raises(ValueError, match=r"expected \(B, C, H, W\)"):
        port_gn._check_cuda_inputs(x[0], s, s, 8, layout="nchw")
    with pytest.raises(ValueError, match="groups"):
        port_gn._check_cuda_inputs(x, s, s, 5, layout="nchw")
    with pytest.raises(TypeError, match="dtype"):
        port_gn._check_cuda_inputs(x.double(), s, s, 8, layout="nchw")
    with pytest.raises(ValueError, match="contiguous"):
        port_gn._check_cuda_inputs(x.to(memory_format=torch.channels_last), s, s, 8,
                                   layout="nchw")
    with pytest.raises(ValueError, match="scale"):
        port_gn._check_cuda_inputs(x, s[:16], s, 8, layout="nchw")
    port_gn._check_cuda_inputs(x, s, s, 8, layout="nchw")
