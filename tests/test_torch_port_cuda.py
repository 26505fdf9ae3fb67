"""PyTorch port: the CUDA flash-attention kernels against their plain
versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so on a machine with a card and
without JAX it runs apart from tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Both head dims are covered: 64 (K1-K3, the SDXL UNet) and 128 (K4a/K4b,
the Anima DiT), with a ragged length and unequal query and key lengths.

Tolerances: the kernels multiply bf16 operands on the tensor cores with
fp32 accumulation (fp32 inputs are rounded to bf16 when staged), so
outputs are held at 2e-2 (bf16) or 1e-2 (fp32 inputs) of unit-scale
values, gradients at five times that, and lse at 1e-3 for bf16 inputs
(exact bf16 products) or 5e-2 for fp32 inputs (logits moved by up to
2^-8 of their size by the staging).
"""

import pytest
import torch

from aozora_sdxl_training_tpu_torch.ops import flash_attention as port


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest "
                    "tests/test_torch_port_cuda.py` on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,sq,skv", [(64, 300, 300), (128, 300, 300),
                                      (128, 333, 1000)])
@pytest.mark.parametrize("dtype,tol,lse_tol", [(torch.bfloat16, 2e-2, 1e-3),
                                               (torch.float32, 1e-2, 5e-2)])
def test_kernels_match_plain_version_on_card(cuda_device, dtype, tol, lse_tol,
                                             d, sq, skv):
    g = torch.Generator(device=cuda_device).manual_seed(d + sq + skv)
    q, do = (torch.randn(2, sq, 3, d, device=cuda_device, dtype=dtype,
                         generator=g) for _ in range(2))
    k, v = (torch.randn(2, skv, 3, d, device=cuda_device, dtype=dtype,
                        generator=g) for _ in range(2))
    scale = d ** -0.5
    counts = dict(port.LAUNCHES)
    out, lse = port.flash_fwd(q, k, v, scale)
    ref_out, ref_lse = port.flash_forward_reference(q, k, v, scale)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=lse_tol)
    got = port.flash_bwd(q, k, v, out, lse, do, scale)
    ref_dq, ref_delta = port.flash_bwd_dq_reference(q, k, v, out, lse, do, scale)
    want = (ref_dq, *port.flash_bwd_dkv_reference(q, k, v, do, lse, ref_delta, scale))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=5 * tol,
                                   atol=5 * tol, msg=name)
    for name in port.KERNEL_NAMES[d]:
        assert port.LAUNCHES[name] == counts[name] + 1, name


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    ok = torch.zeros(1, 8, 1, 64, device=cuda_device, dtype=torch.bfloat16)
    strided = torch.zeros(1, 8, 2, 64, device=cuda_device,
                          dtype=torch.bfloat16)[:, :, :1]
    with pytest.raises(ValueError, match="contiguous"):
        port.flash_fwd(strided, ok, ok, 1.0)
    with pytest.raises(ValueError, match="expected"):
        port.flash_fwd(ok[..., :32].contiguous(), ok, ok, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        port.flash_fwd(ok.half(), ok.half(), ok.half(), 1.0)
    with pytest.raises(ValueError, match="device"):
        port.flash_fwd(ok, ok.cpu(), ok, 1.0)
    counts = dict(port.LAUNCHES)
    port.flash_fwd(ok, ok, ok, 1.0)
    assert port.LAUNCHES["flash_fwd"] == counts["flash_fwd"] + 1


@pytest.mark.cuda
def test_wrappers_raise_at_head_dim_512(cuda_device):
    """The SD-VAE mid-attention head dim has no kernel yet: every wrapper
    raises on the card, and nothing is launched."""
    x = torch.zeros(1, 8, 1, 512, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, 8, device=cuda_device)
    counts = dict(port.LAUNCHES)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        port.flash_fwd(x, x, x, 1.0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        port.flash_bwd_dq(x, x, x, x, lse, x, 1.0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        port.flash_bwd_dkv(x, x, x, x, lse, lse, 1.0)
    assert port.LAUNCHES == counts
