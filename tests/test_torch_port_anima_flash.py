"""PyTorch port: flash attention at head_dim 128 (K4a/K4b) against the JAX
folded Pallas kernels.

At head_dim 128 the JAX package's ``flash_attention`` takes its folded
(B, S, H*D) kernels (``_flash_forward_folded`` / ``_flash_backward_folded``);
here they run in interpret mode, as tests/test_flash_attention.py runs
them, and the port's wrappers run their plain PyTorch version (the CPU
path and the CUDA kernels' oracle). Same numpy inputs into both, fp32.
Forward tolerance 2e-4 and gradient tolerance 5e-4 are the JAX package's
own bars for its kernel against its XLA reference. The kernels themselves
are held to the plain version on the card by chip_smoke.py and
tests/test_torch_port_cuda.py.

Also the dispatch: head_dim 128 goes to the K4 kernels, 512 and 96 raise on
any tensor off the CPU, and no tensor off the CPU takes the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aozora_sdxl_training_tpu.ops.flash_attention import flash_attention as jax_flash
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port

D = 128


def _inputs(seed, sq, skv, b=1, h=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, D)).astype(np.float32),
            rng.normal(size=(b, skv, h, D)).astype(np.float32),
            rng.normal(size=(b, skv, h, D)).astype(np.float32),
            rng.normal(size=(b, sq, h, D)).astype(np.float32))


@pytest.mark.parametrize("sq,skv", [(256, 256), (256, 160), (160, 160)])
def test_forward_and_gradients_match_jax_folded_kernels(sq, skv):
    """(1, 256, 2, 128) and ragged lengths (160 pads to a 256 block in the
    JAX kernels and is masked there; the port's kernels mask in place)."""
    q, k, v, tangent = _inputs(sq * 3 + skv, sq, skv)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v) * tangent)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        g_ref = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = port.flash_attention(qt, kt, vt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-4, atol=2e-4)
    (out * torch.from_numpy(tangent)).sum().backward()
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), g_ref, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


def test_stats_wrappers_match_the_autograd_path():
    """The three wrappers the autograd function chains (forward, dq with
    delta, dk/dv) give what autograd gives on the CPU, in fp32."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, 192, 160))
    scale = D ** -0.5
    out, lse = port.flash_fwd(q, k, v, scale)
    assert out.shape == q.shape and lse.shape == (2, 192)
    assert lse.dtype == torch.float32
    dq, dk, dv = port.flash_bwd(q, k, v, out, lse, do, scale)
    qt, kt, vt = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qt, kt) * scale, -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", ref, vt)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=2e-5, atol=2e-5)
    ref.backward(do)
    for got, want in ((dq, qt.grad), (dk, kt.grad), (dv, vt.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-5, atol=5e-5)


def test_head_dim_dispatch():
    assert port.kernel_names(128) == ("flash_fwd_d128", "flash_bwd_dq_d128",
                                      "flash_bwd_dkv_d128")
    assert port.kernel_names(64) == ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    assert set(port.LAUNCHES) == {n for names in port.KERNEL_NAMES.values()
                                  for n in names}
    with pytest.raises(NotImplementedError, match="not ported yet"):
        port.kernel_names(512)
    with pytest.raises(ValueError, match="head_dim 96"):
        port.kernel_names(96)


@pytest.mark.parametrize("d,error", [(512, NotImplementedError), (96, ValueError),
                                     (128, ValueError), (64, ValueError)])
def test_off_cpu_tensors_never_take_the_plain_path(monkeypatch, d, error):
    """Every wrapper, given tensors that are not on the CPU (``meta`` here,
    as a stand-in for a device), raises before any launch: head_dim 512
    as not ported, head_dim 96 as unknown, and 64 and 128 because the
    device is not CUDA. The plain versions are never called."""
    def plain(*args):
        raise AssertionError("plain version called for a tensor off the CPU")

    for name in ("flash_forward_reference", "flash_bwd_dq_reference",
                 "flash_bwd_dkv_reference"):
        monkeypatch.setattr(port, name, plain)
    x = torch.zeros(1, 8, 1, d, device="meta")
    lse = torch.zeros(1, 8, device="meta")
    counts = dict(port.LAUNCHES)
    with pytest.raises(error):
        port.flash_fwd(x, x, x, 1.0)
    with pytest.raises(error):
        port.flash_bwd_dq(x, x, x, x, lse, x, 1.0)
    with pytest.raises(error):
        port.flash_bwd_dkv(x, x, x, x, lse, lse, 1.0)
    assert port.LAUNCHES == counts
