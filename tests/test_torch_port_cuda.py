"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so on a machine with a card and
without JAX it runs apart from tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

All three head dims of the flash kernels are covered: 64 (K1-K3, the
SDXL UNet), 128 (K4a/K4b, the Anima DiT) and 512 (K4a forward, the SD-VAE
mid-attention), in bf16 and, at 64 and 128, in fp16 (the wgmma kernels of
csrc/flash_attention_sm90.cu, one template per kernel built for both) and,
through the fp32 kernels of csrc/flash_attention_fp32.cu (every one
3xTF32 on the tensor cores), in fp32;
with ragged lengths, unequal query and key lengths, lengths below, at and
one past a tile, two launches that must agree bitwise, and an input the
16-byte loads cannot take.
K5 (the stats-level entry points over those kernels) is held against its
plain versions on a KV shard, and the ring's hop schedule composed on one
card at sp 2 against full attention. K6 (the fused GroupNorm + SiLU
forward) is held against its plain version in both layouts (NHWC, two
kernels a call; NCHW, one), in bf16, fp16 and fp32, at a ragged HW, at C=320
(groups of 10 channels), at a width the 16-byte loads do not divide, at
the widest SDXL_BASE site (whose fp32 slices outgrow shared memory) and at
a large mean; two calls must agree bitwise, and the TINY UNet's fused_gn
route must agree with its unfused one. An optimizer state with bf16 and
with int8 blockwise moments, updated on the card, goes through the
training-state file and back onto the card bit for bit. FSDP's
collectives run over gloo on CUDA tensors (two ranks on the card): the
gathers exact, the reduce-scatter and sync the plain sums; the
point-to-point hop of the SP ring and of the GPipe stages
(``parallel/p2p.exchange``) between two gloo ranks on the card, staged
through pinned host buffers, delivers fp32 and bf16 byte for byte. The QAT repair
trainer's device projection (train/qat_project.py, plain torch on the
card) equals the numpy quantizers' round trip bit for bit in all five
formats, and its error feedback equals the CPU's. The host-moment apply
step (moments in pinned host memory, streamed through a window on the
card) equals the apply step with the moments on the card bit for bit,
leaves the moments pinned and holds the card to the window; the two-pass
step on SDXL_BASE at 1024px updates the UNet as the fused step does. One
fp16 micro step of a small UNet (head_dim 64) and of a small DiT (head_dim
128) through the fp16 kernels agrees with the same step through the einsum
route in fp16.

Tolerances: the bf16 and fp16 kernels multiply 16-bit operands on the
tensor cores with fp32 accumulation, so their outputs are held at 2e-2 of
unit-scale values, gradients at five times that, and lse at 1e-3 (exact
16-bit products). The fp32 kernels multiply to fp32 accuracy (3xTF32), so
outputs and gradients are held at 1e-4 of the plain fp32 version's largest
magnitude (the sums run in another order; with one key, where dq and dk
are zero but for rounding, at 1e-4 of the unit-scale inputs) and lse at
1e-4, and against a float64 version at 1e-5 of its largest magnitude
(their products keep ~2^-22 of each term). K5
and the one-card ring: 2e-2 of the largest magnitude (bf16 kernels; the
ring's merges are fp32). K6: bf16 2e-2
of the largest magnitude (one bf16 rounding of the output), fp16 5e-3 (one
fp16 rounding, 2^-11, with room), fp32 1e-4 of it (fp32 statistics summed
in another order), and 1e-3 against a float64 reference where the mean is
100 times the spread. The fp16 micro steps: the loss within 1e-3 of the
einsum route's, relative, and the gradient of every parameter, as one
vector, at a cosine of at least 0.999 with it (the UNet's 0.997: see the
test).
"""

import gc
import re

import pytest
import torch

from aozora_sdxl_training_tpu_torch.ops import flash_attention as port
from aozora_sdxl_training_tpu_torch.ops import groupnorm_silu as gn
from aozora_sdxl_training_tpu_torch.ops import ring_attention as ring


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest "
                    "tests/test_torch_port_cuda.py` on the card")
    return torch.device("cuda")


LENGTHS = [(300, 300), (333, 1000), (1000, 333), (1, 1), (63, 63), (64, 64), (65, 65),
           (129, 129), (3952, 3952)]


DTYPES = [torch.bfloat16, torch.float16, torch.float32]
DTYPE_IDS = ["bf16", "fp16", "fp32"]


@pytest.mark.cuda
@pytest.mark.parametrize("d,sq,skv", [(d, sq, skv) for d in (64, 128) for sq, skv in LENGTHS])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kernels_match_plain_version_on_card(cuda_device, dtype, d, sq, skv):
    g = torch.Generator(device=cuda_device).manual_seed(d + sq + skv)
    q, do = (torch.randn(2, sq, 3, d, device=cuda_device, dtype=dtype,
                         generator=g) for _ in range(2))
    k, v = (torch.randn(2, skv, 3, d, device=cuda_device, dtype=dtype,
                        generator=g) for _ in range(2))
    scale = d ** -0.5
    counts = dict(port.LAUNCHES)
    out, lse = port.flash_fwd(q, k, v, scale)
    ref_out, ref_lse = port.flash_forward_reference(q, k, v, scale)
    got = port.flash_bwd(q, k, v, out, lse, do, scale)
    ref_dq, ref_delta = port.flash_bwd_dq_reference(q, k, v, out, lse, do, scale)
    want = (ref_dq, *port.flash_bwd_dkv_reference(q, k, v, do, lse, ref_delta, scale))
    if dtype != torch.float32:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=1e-1, atol=1e-1, msg=name)
    else:
        assert _rel_err(out, ref_out) <= 1e-4
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
        # one key: P = 1, so dS = dP - delta and dq, dk are 0 but for the
        # rounding of two sums of the same products; held at 1e-4 of the
        # unit-scale inputs there
        one_key = skv == 1
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if one_key and name != "dv":
                assert a.abs().max().item() <= 1e-4, name
            else:
                assert _rel_err(a, b) <= 1e-4, name
    for name, _ in port.ROUTES[d, dtype]:
        assert port.LAUNCHES[name] == counts[name] + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kernels_are_deterministic_on_card(cuda_device, d, dtype):
    """No atomics: two launches of each kernel at head_dim 64 and 128, bf16,
    fp16 and fp32, give bitwise equal out, lse, dq, dk and dv."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, do = (torch.randn(2, 1000, 3, d, device=cuda_device,
                               dtype=dtype, generator=g) for _ in range(4))
    scale = d ** -0.5
    runs = []
    for _ in range(2):
        out, lse = port.flash_fwd(q, k, v, scale)
        runs.append((out, lse, *port.flash_bwd(q, k, v, out, lse, do, scale)))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_wrappers_raise_on_an_unaligned_input(cuda_device, d, dtype):
    """A contiguous view one element into its storage does not start on a
    16-byte boundary: every wrapper raises before a launch."""
    n = 64 * 2 * d
    base = torch.zeros(n + 1, device=cuda_device, dtype=dtype)
    bad = base[1:].view(1, 64, 2, d)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    ok = torch.zeros(1, 64, 2, d, device=cuda_device, dtype=dtype)
    lse = torch.zeros(2, 64, device=cuda_device)
    counts = dict(port.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        port.flash_fwd(bad, ok, ok, 1.0)
    with pytest.raises(ValueError, match="16-byte"):
        port.flash_fwd(ok, ok, bad, 1.0)
    with pytest.raises(ValueError, match="16-byte"):
        port.flash_bwd_dq(ok, ok, ok, ok, lse, bad, 1.0)
    with pytest.raises(ValueError, match="16-byte"):
        port.flash_bwd_dkv(ok, bad, ok, ok, lse, lse, 1.0)
    assert port.LAUNCHES == counts


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
        port.flash_fwd(ok.double(), ok.double(), ok.double(), 1.0)
    with pytest.raises(TypeError, match="dtypes differ"):
        port.flash_fwd(ok, ok.half(), ok.half(), 1.0)
    d512 = torch.zeros(1, 8, 1, 512, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float16 at head_dim 512 is not ported"):
        port.flash_fwd(d512, d512, d512, 1.0)
    with pytest.raises(ValueError, match="device"):
        port.flash_fwd(ok, ok.cpu(), ok, 1.0)
    counts = dict(port.LAUNCHES)
    port.flash_fwd(ok, ok, ok, 1.0)
    assert port.LAUNCHES["flash_fwd"] == counts["flash_fwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_raise_at_head_dim_512(cuda_device, dtype):
    """The SD-VAE mid-attention head dim has a forward kernel and no
    backward: the forward launches flash_fwd_d512 (bf16) or
    flash_fwd_f32_d512 (fp32) once, and the dQ and dK/dV wrappers and the
    autograd backward raise before any launch."""
    x = torch.zeros(1, 8, 1, 512, device=cuda_device, dtype=dtype)
    lse = torch.zeros(1, 8, device=cuda_device)
    kname = port.route(512, dtype, "forward")[0]
    counts = dict(port.LAUNCHES)
    out, _ = port.flash_fwd(x, x, x, 1.0)
    assert out.shape == x.shape
    assert port.LAUNCHES == {**counts, kname: counts[kname] + 1}
    counts = dict(port.LAUNCHES)
    with pytest.raises(NotImplementedError, match="head_dim 512"):
        port.flash_bwd_dq(x, x, x, x, lse, x, 1.0)
    with pytest.raises(NotImplementedError, match="head_dim 512"):
        port.flash_bwd_dkv(x, x, x, x, lse, lse, 1.0)
    xg = x.clone().requires_grad_(True)
    y = port.flash_attention(xg, x, x)
    with pytest.raises(NotImplementedError, match="head_dim 512"):
        y.sum().backward()
    assert port.LAUNCHES == {**counts, kname: counts[kname] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv", [(1, 1, 2048, 2048), (1, 1, 1000, 1000),
                                        (2, 2, 333, 1000), (1, 1, 1000, 333),
                                        (2, 2, 40, 1000), (1, 1, 65, 65), (1, 3, 65, 1000),
                                        (2, 2, 1000, 3000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_d512_forward_matches_plain_version_on_card(cuda_device, dtype, b, h, sq, skv):
    """flash_fwd_d512 (K4a at head_dim 512, bf16) and flash_fwd_f32_d512
    (fp32) against the plain version, with a ragged length and unequal
    query and key lengths; the tolerances of the module docstring."""
    g = torch.Generator(device=cuda_device).manual_seed(sq + skv)
    q = torch.randn(b, sq, h, 512, device=cuda_device, dtype=dtype, generator=g)
    k, v = (torch.randn(b, skv, h, 512, device=cuda_device, dtype=dtype,
                        generator=g) for _ in range(2))
    scale = 512 ** -0.5
    kname = port.route(512, dtype, "forward")[0]
    counts = dict(port.LAUNCHES)
    out, lse = port.flash_fwd(q, k, v, scale)
    ref_out, ref_lse = port.flash_forward_reference(q, k, v, scale)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    else:
        assert _rel_err(out, ref_out) <= 1e-4
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    assert port.LAUNCHES[kname] == counts[kname] + 1


# (B, H, Sq, Skv) of the fp32 kernels against float64: one head over 4096
# tokens, more queries than keys and the reverse, and lengths a tile
# boundary cuts at both ends (the 3xTF32 kernels at 64 and 128 take 32
# stationary rows a block and 32- or 64-row tiles of the other sequence)
F32_SHAPES = [(1, 1, 4096, 4096), (2, 2, 333, 1000), (2, 2, 1000, 334), (2, 2, 65, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,b,h,sq,skv",
                         [(512, *shape) for shape in F32_SHAPES[:2]]
                         + [(d, *shape) for d in (64, 128) for shape in F32_SHAPES])
def test_f32_forward_matches_float64_on_card(cuda_device, d, b, h, sq, skv):
    """flash_fwd_f32_d{64,128,512} (3xTF32) against attention in float64:
    out and lse within 1e-5 of their largest magnitudes, as fp32 products
    would be."""
    g = torch.Generator(device=cuda_device).manual_seed(sq + d + 7)
    q = torch.randn(b, sq, h, d, device=cuda_device, generator=g)
    k, v = (torch.randn(b, skv, h, d, device=cuda_device, generator=g) for _ in range(2))
    scale = d ** -0.5
    out, lse = port.flash_fwd(q, k, v, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.double())
    assert _rel_err(out.double(), want) <= 1e-5
    assert _rel_err(lse.double(), torch.logsumexp(s, dim=-1).reshape(lse.shape)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d,b,h,sq,skv", [(d, *shape) for d in (64, 128) for shape in F32_SHAPES])
def test_f32_backward_matches_float64_on_card(cuda_device, d, b, h, sq, skv):
    """flash_bwd_dq_f32_d{64,128} and flash_bwd_dkv_f32_d{64,128} (3xTF32)
    against attention's gradients in float64: dq, dk and dv within 1e-5 of
    their largest magnitudes, as fp32 products would be."""
    g = torch.Generator(device=cuda_device).manual_seed(sq + d + 11)
    q, do = (torch.randn(b, sq, h, d, device=cuda_device, generator=g) for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, device=cuda_device, generator=g) for _ in range(2))
    scale = d ** -0.5
    out, lse = port.flash_fwd(q, k, v, scale)
    got = port.flash_bwd(q, k, v, out, lse, do, scale)
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    want = torch.autograd.grad(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vd),
                               (qd, kd, vd), do.double())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(a.double(), w) <= 1e-5, name


def _rel_err(got, want):
    if want.dtype != torch.float64:
        got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


# --------------------------------------------------------------------------
# K5: the stats-level entry points and the one-card ring
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d,sq,skv", [(64, 512, 1024), (128, 512, 1024),
                                      (128, 333, 1000), (128, 1000, 334),
                                      (128, 65, 130)])
@pytest.mark.parametrize("dtype", DTYPES[:2], ids=DTYPE_IDS[:2])
def test_stats_entry_points_match_plain_versions_on_card(cuda_device, dtype, d, sq, skv):
    """flash_fwd_stats on the second of two KV shards; flash_bwd_stats on
    it with the global (out, lse). One counted call each, launching the
    kernels of ``dtype``."""
    g = torch.Generator(device=cuda_device).manual_seed(d + sq + skv)
    q, do = (torch.randn(1, sq, 2, d, device=cuda_device, dtype=dtype,
                         generator=g) for _ in range(2))
    k, v = (torch.randn(1, skv, 2, d, device=cuda_device, dtype=dtype,
                        generator=g) for _ in range(2))
    ks, vs = k[:, skv // 2:].contiguous(), v[:, skv // 2:].contiguous()
    scale = d ** -0.5
    counts, launches = dict(port.STATS_LAUNCHES), dict(port.LAUNCHES)
    out, lse = port.flash_fwd_stats(q, ks, vs)
    ref_out, ref_lse = port.flash_fwd_stats_reference(q, ks, vs, scale)
    assert lse.shape == (1, sq, 2) and lse.dtype == torch.float32
    assert _rel_err(out, ref_out) <= 2e-2
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    g_out, g_lse = port.flash_fwd_stats_reference(q, k, v, scale)
    got = port.flash_bwd_stats(q, ks, vs, g_out, g_lse, do)
    want = port.flash_bwd_stats_reference(q, ks, vs, g_out, g_lse, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(a, b) <= 2e-2, name
    assert port.STATS_LAUNCHES == {"flash_fwd_stats": counts["flash_fwd_stats"] + 1,
                                   "flash_bwd_stats": counts["flash_bwd_stats"] + 1}
    assert {n: port.LAUNCHES[n] - c for n, c in launches.items() if port.LAUNCHES[n] != c} == {
        name: 1 for name, _ in port.ROUTES[d, dtype]}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES[:2], ids=DTYPE_IDS[:2])
def test_ring_on_one_card_matches_full_attention(cuda_device, dtype, n):
    """The ring's hop schedule over n KV shards (head_dim 128, bf16 or fp16:
    the SP ranks' path under MIXED_PRECISION float16) against full
    attention: output and dq/dk/dv; n * n calls of each entry point."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    q, k, v, do = (torch.randn(1, 1024, 2, 128, device=cuda_device,
                               dtype=dtype, generator=g) for _ in range(4))
    scale = 128 ** -0.5
    counts = dict(port.STATS_LAUNCHES)
    out, lse, dq, dk, dv = ring.ring_on_one_device(q, k, v, do, n)
    ref_out, ref_lse = port.flash_fwd_stats_reference(q, k, v, scale)
    want = port.flash_bwd_stats_reference(q, k, v, ref_out, ref_lse, do, scale)
    assert _rel_err(out, ref_out) <= 2e-2
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _rel_err(a, b) <= 2e-2, name
    assert port.STATS_LAUNCHES == {key: c + n * n for key, c in counts.items()}


# --------------------------------------------------------------------------
# K6: fused GroupNorm + SiLU
# --------------------------------------------------------------------------

K6_DTYPES = [(torch.bfloat16, 2e-2), (torch.float16, 5e-3), (torch.float32, 1e-4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [
    ((1, 32, 32, 320), 32), ((2, 37, 53, 640), 32), ((1, 8, 8, 320), 32),
    ((1, 16, 16, 36), 12), ((1, 64, 64, 1280), 32), ((1, 5, 3, 2560), 32)])
@pytest.mark.parametrize("dtype,tol", K6_DTYPES, ids=DTYPE_IDS)
def test_group_norm_silu_kernel_matches_plain_version_on_card(cuda_device, shape,
                                                              groups, dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    c = shape[-1]
    x = (torch.randn(shape, device=cuda_device, generator=g) * 2 + 0.5).to(dtype)
    scale = 1 + 0.3 * torch.randn(c, device=cuda_device, generator=g)
    bias = 0.2 * torch.randn(c, device=cuda_device, generator=g)
    counts = dict(gn.LAUNCHES)
    y = gn.group_norm_silu_forward(x, scale, bias, groups)
    assert y.dtype == dtype and y.shape == x.shape
    assert _rel_err(y, gn.group_norm_silu_reference(x, scale, bias, groups)) <= tol
    assert gn.LAUNCHES["group_norm_silu"] == counts["group_norm_silu"] + 1


@pytest.mark.cuda
def test_group_norm_silu_kernel_keeps_the_variance_at_a_large_mean(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(1, 32, 32, 320, device=cuda_device, generator=g) + 100.0
    scale, bias = torch.ones(320, device=cuda_device), torch.zeros(320, device=cuda_device)
    y = gn.group_norm_silu_forward(x, scale, bias, 32)
    xd = x.double().reshape(1, 32 * 32, 32, 10)
    xd = ((xd - xd.mean(dim=(1, 3), keepdim=True))
          / (xd.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-5).sqrt())
    want = torch.nn.functional.silu(xd.reshape(x.shape))
    assert _rel_err(y, want) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", K6_DTYPES, ids=DTYPE_IDS)
def test_group_norm_silu_op_gradients_on_card(cuda_device, dtype, tol):
    """The op with use_pallas=True (kernel forward, plain backward) against
    the plain composition under autograd: output and the gradients of x,
    scale and bias."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x0 = torch.randn(2, 16, 16, 320, device=cuda_device, generator=g).to(dtype)
    s0 = 1 + 0.3 * torch.randn(320, device=cuda_device, generator=g)
    b0 = 0.2 * torch.randn(320, device=cuda_device, generator=g)
    tangent = torch.randn(x0.shape, device=cuda_device, generator=g)
    results = []
    for use_pallas in (True, None):
        x, s, b = (t.clone().requires_grad_(True) for t in (x0, s0, b0))
        y = gn.group_norm_silu(x, s, b, groups=32, use_pallas=use_pallas)
        (y.float() * tangent).sum().backward()
        results.append((y, x.grad, s.grad, b.grad))
    for name, a, b in zip(("y", "dx", "dscale", "dbias"), *results):
        assert _rel_err(a, b) <= tol, name


@pytest.mark.cuda
def test_group_norm_silu_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(1, 4, 4, 32, device=cuda_device)
    s = torch.ones(32, device=cuda_device)
    counts = dict(gn.LAUNCHES)
    with pytest.raises(TypeError, match="dtype"):
        gn.group_norm_silu_forward(x.double(), s, s, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu_forward(x.permute(0, 2, 1, 3), s, s, 8)
    with pytest.raises(ValueError, match="scale"):
        gn.group_norm_silu_forward(x, s.cpu(), s, 8)
    assert gn.LAUNCHES == counts


K6_SHAPES = [((1, 32, 32, 320), 32), ((2, 37, 53, 640), 32), ((1, 8, 8, 320), 32),
             ((1, 16, 16, 36), 12), ((1, 64, 64, 1280), 32), ((1, 5, 3, 2560), 32),
             ((1, 128, 128, 960), 32)]


def _gn_inputs(device, shape, dtype, seed, mean=0.5):
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, device=device, generator=g) * 2 + mean).to(dtype)
    return (x, 1 + 0.3 * torch.randn(c, device=device, generator=g),
            0.2 * torch.randn(c, device=device, generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", K6_SHAPES)
@pytest.mark.parametrize("dtype,tol", K6_DTYPES, ids=DTYPE_IDS)
def test_group_norm_silu_nchw_kernel_matches_plain_version_on_card(cuda_device, shape,
                                                                   groups, dtype, tol):
    x, scale, bias = _gn_inputs(cuda_device, shape, dtype, sum(shape))
    x = x.permute(0, 3, 1, 2).contiguous()
    counts = dict(gn.LAUNCHES)
    y = gn.group_norm_silu_nchw_forward(x, scale, bias, groups)
    assert y.dtype == dtype and y.shape == x.shape
    assert _rel_err(y, gn.group_norm_silu_nchw_reference(x, scale, bias, groups)) <= tol
    assert gn.LAUNCHES == {**counts, "group_norm_silu_nchw": counts["group_norm_silu_nchw"] + 1}


@pytest.mark.cuda
def test_group_norm_silu_nchw_kernel_keeps_the_variance_at_a_large_mean(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(1, 320, 32, 32, device=cuda_device, generator=g) + 100.0
    scale, bias = torch.ones(320, device=cuda_device), torch.zeros(320, device=cuda_device)
    y = gn.group_norm_silu_nchw_forward(x, scale, bias, 32)
    xd = x.double().reshape(1, 32, 10 * 32 * 32)
    xd = ((xd - xd.mean(dim=2, keepdim=True))
          / (xd.var(dim=2, unbiased=False, keepdim=True) + 1e-5).sqrt())
    want = torch.nn.functional.silu(xd.reshape(x.shape))
    assert _rel_err(y, want) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("layout,kernels", [("nhwc", 2), ("nchw", 1)])
def test_group_norm_silu_launches_its_kernels_once_a_call(cuda_device, layout, kernels):
    """The profiler sees the NHWC op's two kernels (statistics, apply) and
    the NCHW entry's one, once each in a call."""
    from torch.profiler import ProfilerActivity, profile
    x, scale, bias = _gn_inputs(cuda_device, (1, 64, 64, 640), torch.bfloat16, 5)
    fn = gn.group_norm_silu_forward
    if layout == "nchw":
        x, fn = x.permute(0, 3, 1, 2).contiguous(), gn.group_norm_silu_nchw_forward
    fn(x, scale, bias, 32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(x, scale, bias, 32)
        torch.cuda.synchronize()
    launched = [e.key for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    assert len(launched) == kernels, launched
    assert all(re.search(r"\bgn_\w+_kernel", k) for k in launched), launched


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_group_norm_silu_kernels_are_deterministic_on_card(cuda_device, layout, dtype):
    x, scale, bias = _gn_inputs(cuda_device, (1, 128, 128, 960), dtype, 9)
    fn = gn.group_norm_silu_forward
    if layout == "nchw":
        x, fn = x.permute(0, 3, 1, 2).contiguous(), gn.group_norm_silu_nchw_forward
    assert torch.equal(fn(x, scale, bias, 32), fn(x, scale, bias, 32))


@pytest.mark.cuda
def test_group_norm_silu_nchw_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(1, 32, 4, 4, device=cuda_device)
    s = torch.ones(32, device=cuda_device)
    counts = dict(gn.LAUNCHES)
    with pytest.raises(TypeError, match="dtype"):
        gn.group_norm_silu_nchw_forward(x.double(), s, s, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu_nchw_forward(x.to(memory_format=torch.channels_last), s, s, 8)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_silu_nchw_forward(x, s, s, 5)
    with pytest.raises(ValueError, match="scale"):
        gn.group_norm_silu_nchw_forward(x, s.cpu(), s, 8)
    with pytest.raises(ValueError, match="scale"):
        gn.group_norm_silu_nchw_forward(x, s[:16], s, 8)
    assert gn.LAUNCHES == counts


@pytest.mark.cuda
def test_tiny_unet_fused_gn_route_on_card(cuda_device, monkeypatch):
    """The TINY UNet in fp32 with fused_gn (the NCHW kernel at each of its
    34 resnet norm sites, the plain backward) against the unfused route:
    output and parameter gradients at 1e-4 of their largest magnitude.
    cuDNN's TF32 convolutions are turned off: they round each input to 10
    bits, which turns the routes' 1e-6 differences into 1e-3."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import TINY
    from aozora_sdxl_training_tpu_torch.models.sdxl.unet import init_params, unet_forward
    g = torch.Generator(device=cuda_device).manual_seed(4)
    params = init_params(TINY, g)
    for p in params.values():
        p.requires_grad_(True)
    args = (torch.randn(2, 32, 32, 4, device=cuda_device, generator=g),
            torch.tensor([10.0, 700.0], device=cuda_device),
            torch.randn(2, 7, TINY.cross_attention_dim, device=cuda_device, generator=g),
            torch.randn(2, TINY.pooled_projection_dim, device=cuda_device, generator=g),
            torch.tensor([[512.0, 512, 0, 0, 512, 512]] * 2, device=cuda_device))
    results = []
    for fused in (False, True):
        counts = dict(gn.LAUNCHES)
        out = unet_forward(params, *args, cfg=TINY, compute_dtype=torch.float32,
                           fused_gn=fused)
        grads = torch.autograd.grad(out.square().mean(), list(params.values()))
        results.append((out.detach(), grads))
        assert (gn.LAUNCHES["group_norm_silu_nchw"] - counts["group_norm_silu_nchw"]
                == (34 if fused else 0))
    (want, want_g), (got, got_g) = results
    assert _rel_err(got, want) <= 1e-4
    assert max(_rel_err(a, b) for a, b in zip(got_g, want_g) if b.abs().max() > 0) <= 1e-4


@pytest.mark.cuda
def test_anima_cache_encoders_match_the_cpu_on_card(cuda_device):
    """The Anima cache's encoders (no kernel of the port's own: cuBLAS and
    cuDNN through torch, TF32 off) at TINY sizes on the card against the
    same functions on the CPU in fp32: Qwen3 over padded captions with ids
    past its vocabulary, and the Wan VAE's tiled encode over ragged tiles;
    1e-4 of the largest magnitude (fp32 sums in another order)."""
    from aozora_sdxl_training_tpu_torch.models.anima import qwen3, wan_vae
    g = torch.Generator().manual_seed(4)
    q_params = qwen3.init_params(qwen3.TINY_QWEN3, g)
    v_params = wan_vae.init_params(wan_vae.TINY_WAN_VAE, g)
    ids = torch.randint(0, 49408, (2, 40), generator=g)
    mask = torch.ones(2, 40, dtype=torch.int32)
    mask[1, 17:] = 0
    pixels = (torch.rand(1, 72, 56, 3, generator=g) * 2 - 1).numpy()
    outs = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for device in (torch.device("cpu"), cuda_device):
            qp = {k: t.to(device) for k, t in q_params.items()}
            vp = wan_vae.params_from_torch_state({k: t.to(device) for k, t in v_params.items()})
            outs.append((
                qwen3.qwen3_forward(qp, ids.to(device), mask.to(device),
                                    qwen3.TINY_QWEN3).cpu(),
                torch.from_numpy(wan_vae.encode_image_tiled(
                    vp, pixels, cfg=wan_vae.TINY_WAN_VAE, tile_size=(4, 4),
                    tile_stride=(3, 3)))))
    for want, got in zip(*outs):
        assert _rel_err(got, want) <= 1e-4


@pytest.mark.cuda
def test_fsdp_collectives_over_gloo_on_cuda_tensors(cuda_device, tmp_path):
    """Two gloo ranks on the one card (``tests/test_torch_port_ranks.py``,
    task ``fsdp``): gloo takes all_gather_into_tensor, reduce_scatter_tensor
    and all_reduce on CUDA tensors (the probe: the task runs each), the
    gradients stay on the card, each sharded tensor gathers back bit for
    bit, and the reduce-scatter and sync give the plain sums of the ranks'
    gradients (fp32, rtol 1e-6), buckets small and large."""
    import numpy as np
    from tests.test_torch_port_ranks import run_task
    rng = np.random.default_rng(0)
    shapes = {"down.conv.weight": (8, 6, 3, 3), "ff.proj.weight": (40, 12),
              "norm.bias": (40,), "odd.weight": (7, 9)}
    for bucket in (64, 1 << 20):
        arrays = {"dp": 2, "sp": 1, "min": 64, "bucket": bucket, "device": "cuda"}
        for name, shape in shapes.items():
            arrays[f"full.{name}"] = rng.normal(size=shape).astype(np.float32)
            arrays[f"grad.{name}"] = rng.normal(size=(2, *shape)).astype(np.float32)
        work = tmp_path / str(bucket)
        work.mkdir()
        np.savez(work / "inputs.npz", **arrays)
        for got in run_task("fsdp", 2, work / "inputs.npz", work, timeout=180):
            assert str(got["backend"]) == "gloo"
            assert set(got["sharded"]) == {"down.conv.weight", "ff.proj.weight"}
            for name in shapes:
                assert str(got[f"device.{name}"]).startswith("cuda")
                if name in set(got["sharded"]):
                    np.testing.assert_array_equal(got[f"gathered.{name}"],
                                                  arrays[f"full.{name}"])
                np.testing.assert_allclose(got[f"reduced.{name}"],
                                           arrays[f"grad.{name}"].sum(axis=0),
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_tp_functions_over_gloo_on_cuda_tensors(cuda_device, tmp_path):
    """Two gloo ranks on the one card (``tests/test_torch_port_ranks.py``,
    task ``tp``), one tp group: "reduce" sums the ranks' inputs (its
    gradient the rank's own upstream one), "copy" is the identity (its
    gradient the sum of the ranks' upstream ones), "gather" concatenates
    the ranks' columns (its gradient the rank's columns of the upstream
    one), "scatter" keeps the rank's columns (its gradient gathered); on
    the card, in fp32 (exact up to the sums' order) and bf16."""
    import numpy as np
    from tests.test_torch_port_ranks import run_task
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    arrays = {"x": x, "device": "cuda",
              "g_reduce": rng.normal(size=(2, 3, 5, 8)).astype(np.float32),
              "g_copy": rng.normal(size=(2, 3, 5, 8)).astype(np.float32),
              "g_gather": rng.normal(size=(2, 3, 5, 16)).astype(np.float32),
              "g_scatter": rng.normal(size=(2, 3, 5, 4)).astype(np.float32)}
    np.savez(tmp_path / "inputs.npz", **arrays)
    ranks = run_task("tp", 2, tmp_path / "inputs.npz", tmp_path, timeout=180)
    for r, got in enumerate(ranks):
        g = {k: arrays[f"g_{k}"] for k in ("reduce", "copy", "gather", "scatter")}
        want = {"reduce": (x.sum(0), g["reduce"][r]),
                "copy": (x[r], g["copy"].sum(0)),
                "gather": (np.concatenate([x[0], x[1]], axis=-1),
                           g["gather"][r][..., 8 * r:8 * (r + 1)]),
                "scatter": (x[r][..., 4 * r:4 * (r + 1)],
                            np.concatenate([g["scatter"][0], g["scatter"][1]], axis=-1))}
        for tag, tol in (("float32", 1e-6), ("bfloat16", 2e-2)):
            for kind, (out, grad) in want.items():
                assert str(got[f"{tag}.{kind}.device"]).startswith("cuda")
                np.testing.assert_allclose(got[f"{tag}.{kind}.out"], out, rtol=tol, atol=tol)
                np.testing.assert_allclose(got[f"{tag}.{kind}.grad"], grad, rtol=tol, atol=tol)
        assert all(int(got[f"bytes.{k}"]) > 0 for k in ("reduce", "copy", "gather", "scatter"))


@pytest.mark.cuda
def test_p2p_hop_over_gloo_on_cuda_tensors(cuda_device, tmp_path):
    """``parallel.p2p.exchange`` between two gloo ranks on the one card
    (``tests/test_torch_port_ranks.py``, task ``hop``): gloo's own
    send/recv hand a CUDA tensor's device pointer to its TCP transport,
    so a gloo group stages the hop through pinned host buffers; each rank
    receives, on the card, what the other sent, byte for byte, in fp32
    and bf16 (odd sizes too)."""
    import numpy as np
    import torch
    from tests.test_torch_port_ranks import run_task
    for shape in ((2, 3, 4096, 16), (2, 1001)):
        x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
        work = tmp_path / "x".join(map(str, shape))
        work.mkdir()
        np.savez(work / "inputs.npz", x=x, device="cuda")
        ranks = run_task("hop", 2, work / "inputs.npz", work, timeout=120)
        for rank, got in enumerate(ranks):
            assert bool(got["staged"])
            src = torch.from_numpy(x[(rank - 1) % 2])
            for name, dtype, bits in (("float32", torch.float32, torch.int32),
                                      ("bfloat16", torch.bfloat16, torch.int16)):
                assert str(got[f"{name}.device"]).startswith("cuda")
                np.testing.assert_array_equal(got[f"{name}.bits"],
                                              src.to(dtype).view(bits).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", ["bfloat16", "int8_blockwise"])
def test_train_state_round_trip_on_card(cuda_device, tmp_path, momentum):
    """Moments made on the card by two AdamW steps (int8 codes in the JAX
    layout, fp32 for the tensor under min_8bit_size) are saved with
    save_train_state and restored onto the card by load_train_state and
    restored_state: equal bit for bit, the metadata too."""
    from aozora_sdxl_training_tpu_torch.ckpt.train_state import (
        load_train_state, save_train_state)
    from aozora_sdxl_training_tpu_torch.models.sdxl import conversion
    from aozora_sdxl_training_tpu_torch.opt import adamw
    layout = adamw.Layout(conversion.to_jax_layout, conversion.from_jax_layout)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shapes = {"conv.weight": (40, 24, 3, 3), "proj.weight": (300, 70), "norm.weight": (77,)}
    params = {n: torch.randn(s, generator=g, device=cuda_device) for n, s in shapes.items()}
    cfg = adamw.AdamWConfig.from_params_dict({"momentum_dtype": momentum,
                                              "min_8bit_size": 1000})
    state = adamw.init_state(params, cfg, layout)
    for _ in range(2):
        grads = {n: torch.randn(p.shape, generator=g, device=cuda_device) * 0.1
                 for n, p in params.items()}
        adamw.apply_updates(params, grads, state, cfg, lr=1e-3)
    meta = dict(global_step=2, micro_step=8, sampler_seed=5, sampler_epoch=0,
                timestep_sampler_state={"pool_index": 8})
    save_train_state(tmp_path / "state.safetensors", opt_state=state,
                     extra={"schedule_global_batch": 1}, **meta)
    got_meta, host = load_train_state(tmp_path / "state.safetensors", layout)
    assert got_meta == {**meta, "schedule_global_batch": 1}
    back = adamw.restored_state(host, params, cfg)
    assert back.step == state.step == 2
    for field in ("exp_avg", "exp_avg_sq"):
        for name, want in getattr(state, field).items():
            got = getattr(back, field)[name]
            pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
            assert isinstance(want, tuple) == (momentum == "int8_blockwise"
                                               and name != "norm.weight")
            for a, b in pairs:
                assert a.device.type == "cuda" and a.dtype == b.dtype
                assert torch.equal(a, b), f"{field} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_dispatcher_ops_launch_the_kernels_and_match_plain_versions(cuda_device, d, dtype):
    """``aozora::flash_fwd`` and ``aozora::flash_bwd`` on the card launch
    one kernel per role (never the plain version) and agree with the plain
    versions at the tolerances above; ``FlashAttention.apply``'s autograd
    goes through the backward op."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v, do = (torch.randn(1, 700, 2, d, device=cuda_device, dtype=dtype, generator=g)
                   for _ in range(4))
    scale = d ** -0.5
    fwd, dq, dkv = (port.route(d, dtype, role)[0] for role in port.ROLES)
    before = dict(port.LAUNCHES)
    out, lse = torch.ops.aozora.flash_fwd(q, k, v, scale)
    grads = torch.ops.aozora.flash_bwd(q, k, v, out, lse, do, scale)
    ref_out, ref_lse = port.flash_forward_reference(q, k, v, scale)
    ref_grads = port.flash_bwd(*(t.cpu() for t in (q, k, v)), ref_out.cpu(),
                               ref_lse.cpu(), do.cpu(), scale)
    launched = {n: port.LAUNCHES[n] - before[n] for n in port.LAUNCHES}
    assert launched == {n: int(n in (fwd, dq, dkv)) for n in port.LAUNCHES}
    tol = 2e-2 if dtype != torch.float32 else 1e-4 * float(ref_out.abs().max())
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    for got, want in zip(grads, ref_grads):
        bar = 5 * tol if dtype != torch.float32 else 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got.float().cpu(), want.float(), rtol=0, atol=bar)
    qt, kt, vt = (t.clone().requires_grad_(True) for t in (q, k, v))
    port.flash_attention(qt, kt, vt).backward(do)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES[:2], ids=DTYPE_IDS[:2])
def test_conservative_remat_skips_the_flash_forward_on_card(cuda_device, monkeypatch, dtype):
    """A small bf16 or fp16 DiT at head_dim 128 on the card: Conservative
    launches the forward kernel once a block, Full twice, and both give the
    Off gradients (the recompute repeats the same kernels: bit for bit)."""
    from dataclasses import replace
    from aozora_sdxl_training_tpu_torch.models.anima import dit
    cfg = replace(dit.TINY_ANIMA, model_channels=256, num_heads=2, num_blocks=2)
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", "1024")
    g = torch.Generator(device=cuda_device).manual_seed(3)
    params = dit.init_params(cfg, g)
    lat = torch.randn(1, 1, 64, 64, cfg.in_channels, device=cuda_device, generator=g)
    ctx = torch.randn(1, 12, cfg.adapter_source_dim, device=cuda_device, generator=g)
    ids = torch.randint(1, cfg.adapter_vocab, (1, 12), device=cuda_device, generator=g)
    t = torch.tensor([0.4], device=cuda_device)
    grads, fwd = {}, {}
    for remat in (False, True, "conservative"):
        for p in params.values():
            p.requires_grad_(True).grad = None
        port.reset_launch_counts()
        out = dit.dit_forward(params, lat, t, ctx, cfg=cfg, t5_ids=ids, attn_impl="flash",
                              compute_dtype=dtype, remat=remat)
        out.float().square().mean().backward()
        fwd[remat] = port.LAUNCHES[port.route(128, dtype, "forward")[0]]
        grads[remat] = {n: p.grad.clone() for n, p in params.items()}
    assert fwd == {False: cfg.num_blocks, True: 2 * cfg.num_blocks,
                   "conservative": cfg.num_blocks}
    for remat in (True, "conservative"):
        for n in params:
            assert torch.equal(grads[remat][n], grads[False][n]), (remat, n)


def _cosine(a, b):
    a, b = (torch.cat([t.double().flatten() for t in ts]) for ts in (a, b))
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["unet", "dit"])
def test_fp16_micro_step_through_the_kernels_matches_the_einsum_route(cuda_device,
                                                                     monkeypatch, model):
    """One MIXED_PRECISION float16 micro step (fp32 masters, fp16 compute)
    of a small UNet (head_dim 64: K1-K3 in fp16) and of a small DiT
    (head_dim 128: K4a/K4b in fp16, Full remat) through the flash kernels
    against the same step through the einsum route in fp16: the loss within
    1e-3 relative, the gradient of every trainable tensor, as one vector, at
    a cosine of at least 0.999 (the DiT) or 0.997 (the UNet); the flash run
    launches the fp16 kernels only.

    The kernels round dS = P (dP - delta) scale to fp16 before dQ += dS K
    and dK += dS^T Q, as the JAX package's Pallas kernels do (and as the
    bf16 kernels round it to bf16); the einsum route's autograd keeps the
    logits' gradient in fp32. The UNet's mean loss over 32,768 elements
    starts the backward near fp16's subnormal range, so dS falls below it
    in places: the UNet's cosine measured 0.9984 on the card, and 0.99863
    on the CPU with the plain version rounding dS to fp16 the same way
    (0.99999 without that rounding). The DiT's stays at 1.00000."""
    from dataclasses import replace
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", "256")
    g = torch.Generator(device=cuda_device).manual_seed(7)
    f16 = torch.float16
    if model == "unet":
        from aozora_sdxl_training_tpu_torch.models.sdxl.arch import UNetConfig
        from aozora_sdxl_training_tpu_torch.models.sdxl.unet import init_params
        from aozora_sdxl_training_tpu_torch.train import train_step as ts
        cfg = UNetConfig(block_out_channels=(64, 128, 128), transformer_layers=(0, 1, 1),
                         num_heads=(1, 2, 2), mid_transformer_layers=1,
                         cross_attention_dim=64, norm_num_groups=8,
                         addition_time_embed_dim=16, pooled_projection_dim=40)
        params = init_params(cfg, g)
        batch = (0.2 * torch.randn(2, 64, 64, 4, device=cuda_device, generator=g),
                 torch.randn(2, 77, 64, device=cuda_device, generator=g),
                 torch.randn(2, 40, device=cuda_device, generator=g),
                 torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device=cuda_device),
                 torch.tensor([10, 700], device=cuda_device),
                 torch.ones(2, device=cuda_device), torch.ones(1000, device=cuda_device))
        noise = torch.randn(2, 64, 64, 4, device=cuda_device, generator=g)

        def step(impl):
            return ts.make_micro_step(ts.TrainStepConfig(
                unet=cfg, attn_impl=impl, compute_dtype=f16))

        kernels = ("flash_fwd_f16", "flash_bwd_dq_f16", "flash_bwd_dkv_f16")
    else:
        from aozora_sdxl_training_tpu_torch.models.anima import dit
        from aozora_sdxl_training_tpu_torch.train import anima_trainer as at
        cfg = replace(dit.TINY_ANIMA, model_channels=256, num_heads=2, num_blocks=2)
        params = dit.init_params(cfg, g)
        batch = (0.5 * torch.randn(1, 32, 32, cfg.in_channels, device=cuda_device, generator=g),
                 torch.randn(1, 12, cfg.adapter_source_dim, device=cuda_device, generator=g),
                 torch.randint(1, cfg.adapter_vocab, (1, 12), device=cuda_device, generator=g),
                 torch.tensor([400], device=cuda_device), torch.ones(1, device=cuda_device),
                 torch.ones(1000, device=cuda_device))
        noise = torch.randn(1, 32, 32, cfg.in_channels, device=cuda_device, generator=g)

        def step(impl):
            return at.make_anima_micro_step(at.AnimaStepConfig(
                dit=cfg, attn_impl=impl, compute_dtype=f16, remat=True))

        kernels = ("flash_fwd_f16_d128", "flash_bwd_dq_f16_d128", "flash_bwd_dkv_f16_d128")
    losses, grads = {}, {}
    for impl in ("xla", "flash"):
        for p in params.values():
            p.requires_grad_(True).grad = None
        port.reset_launch_counts()
        loss, _ = step(impl)(params, {}, *batch, 0, 1, 0.0, noise=noise)
        losses[impl] = float(loss)
        grads[impl] = [p.grad for p in params.values()]
        launched = {n for n, c in port.LAUNCHES.items() if c}
        assert launched == (set(kernels) if impl == "flash" else set()), launched
        assert all(bool(torch.isfinite(gr).all()) for gr in grads[impl])
    assert abs(losses["flash"] - losses["xla"]) <= 1e-3 * abs(losses["xla"]), losses
    assert _cosine(grads["flash"], grads["xla"]) >= (0.997 if model == "unet" else 0.999)


def _qat_weight(shape, seed):
    """A weight with rows at very different scales, a zero row, -0.0
    entries, and values on the fp8 and int8 grids' midpoints."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * rng.uniform(0.01, 2.0, size=(shape[0], 1))).astype(np.float32)
    w[::5] *= 1e-4
    w[1] = 0.0
    w[2, :3] = -0.0
    w[3, :8] = np.float32([448.0, 0.5, 1.5, 2.5, -3.5, 13.0, 0.0078125, 448.0 / 3])
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["float8_e4m3fn", "float8_e5m2", "int8_tensorwise", "nvfp4",
                                 "ternary_1_58"])
def test_qat_projection_on_card_matches_the_numpy_quantizer(cuda_device, fmt):
    """The device projection of the QAT repair trainer on the card, bit for
    bit the numpy quantizer's round trip (quantize, then dequantize), at
    1024 x 2048 and at a row width past 8192 elements (where numpy versions
    sum the ternary row mean in two orders); then
    three steps of error feedback on the card against the same steps on
    the CPU, parameters and fp16 residuals bit for bit."""
    import numpy as np
    from aozora_sdxl_training_tpu_torch.tools import quantize as q
    from aozora_sdxl_training_tpu_torch.train import qat_project
    for shape in ((1024, 2048), (64, 8208)):
        w = _qat_weight(shape, sum(shape))
        records = dict(q.quant_records_for_weight("w.weight", w, fmt))
        want = np.asarray(q.dequantize_records("w.weight", records, out_shape=shape), np.float32)
        got = qat_project.project_weight(fmt, torch.from_numpy(w).to(cuda_device))
        assert got.dtype == torch.float32
        assert np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32)), shape
    w = _qat_weight((256, 512), 9)
    init, project = qat_project.make_device_projector({"w.weight": fmt}, {"w.weight": 0.9})
    runs = []
    for device in ("cpu", cuda_device):
        params = {"w.weight": torch.from_numpy(w.copy()).to(device)}
        res = init(params)
        for step in range(3):
            params["w.weight"] += 0.01 * (step + 1)
            project(params, res)
        runs.append((params["w.weight"].cpu(), res["w.weight"].cpu()))
    (p_cpu, r_cpu), (p_dev, r_dev) = runs
    assert r_dev.dtype == torch.float16
    assert torch.equal(p_dev.view(torch.int32), p_cpu.view(torch.int32))
    assert torch.equal(r_dev.view(torch.int16), r_cpu.view(torch.int16))


ROUNDING = 2 << 20


def _moment_tensors(state):
    for field in ("exp_avg", "exp_avg_sq"):
        for name, m in getattr(state, field).items():
            yield from ((f"{field} {name}", t) for t in (m if isinstance(m, tuple) else (m,)))


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["below_largest", "above_largest"])
@pytest.mark.parametrize("momentum", ["int8_blockwise", "bfloat16"])
def test_streamed_host_moments_match_the_card_bit_for_bit(cuda_device, momentum, window):
    """From the same bf16 parameters, gradients and state, two apply steps
    with the moments in pinned host memory (streamed through a window
    smaller than the largest tensor's moments, or larger) give the
    parameters and moments (int8 codes and scales, or bf16) of two apply
    steps with the moments on the card, bit for bit; the moments are still
    pinned afterwards. ``max_memory_allocated`` during the streamed steps
    stays within what the card held before them (the window and the spill
    buffer, where a tensor larger than the window is staged, included) and
    their gradients, plus the scratch the on-card apply needs above what it
    holds (one tensor's fp32 update), plus 2 MiB for the caching
    allocator's rounding (a large block can count up to 1 MiB over its
    request)."""
    from aozora_sdxl_training_tpu_torch.opt import adamw
    g = torch.Generator(device=cuda_device).manual_seed(11)
    shapes = {f"w{i}": ((1024, 1024) if i % 3 else (320, 64, 3, 3)) for i in range(96)}
    shapes.update({"norm": (640,), "small": (40, 24)})
    params = {n: torch.randn(s, generator=g, device=cuda_device).to(torch.bfloat16)
              for n, s in shapes.items()}
    grads = [{n: torch.randn(p.shape, generator=g, device=cuda_device).to(torch.bfloat16)
              for n, p in params.items()} for _ in range(2)]
    cfg = adamw.AdamWConfig.from_params_dict({"momentum_dtype": momentum})
    probe = adamw.init_state(params, cfg)
    largest = max(sum(t.numel() * t.element_size()
                      for m in (probe.exp_avg[n], probe.exp_avg_sq[n])
                      for t in (m if isinstance(m, tuple) else (m,)))
                  for n in params)
    del probe
    window_bytes = largest // 2 if window == "below_largest" else 8 * largest
    runs = {}
    for kind in ("card", "host"):
        gc.collect()            # an earlier test's tensors must not go mid-run
        torch.cuda.empty_cache()
        trainable = {n: p.clone() for n, p in params.items()}
        state = adamw.init_state(trainable, cfg,
                                 host_window=window_bytes if kind == "host" else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for step, grad in enumerate(grads):
            adamw.apply_updates(trainable, {n: t.clone() for n, t in grad.items()}, state,
                                cfg, lr=1e-3 * (step + 1))
        if kind == "host":
            state.host.synchronize()
        torch.cuda.synchronize()
        runs[kind] = (trainable, state, held, torch.cuda.max_memory_allocated())
    (p_card, s_card, held_card, peak_card), (p_host, s_host, held_host, peak_host) = (
        runs["card"], runs["host"])
    for name in params:
        assert torch.equal(p_host[name], p_card[name]), name
    for (what, a), (_, b) in zip(_moment_tensors(s_host), _moment_tensors(s_card)):
        assert a.device.type == "cpu" and a.is_pinned(), what
        assert torch.equal(a, b.cpu()), what
    grad_bytes = sum(t.numel() * t.element_size() for t in grads[0].values())
    scratch = max(peak_card - held_card - grad_bytes, 0)
    moments_card = sum(t.numel() * t.element_size() for _, t in _moment_tensors(s_card))
    bound = held_host + grad_bytes + scratch + ROUNDING
    print(f"{momentum}, window {window_bytes} B: peak {peak_host} B against {bound} B "
          f"(held {held_host}, gradients {grad_bytes}, scratch {scratch}, the moments "
          f"{moments_card} B on the card); {s_host.host.bytes_h2d} B in, "
          f"{s_host.host.bytes_d2h} B out")
    assert peak_host <= bound
    moved = 2 * sum(c["size"] for c in s_host.host.chunks)
    assert s_host.host.bytes_h2d == s_host.host.bytes_d2h == moved >= 2 * moments_card


@pytest.mark.cuda
def test_two_pass_step_matches_the_fused_step_on_sdxl_base(cuda_device):
    """One optimizer step of SDXL_BASE at 1024px (random weights, bf16
    masters, int8 moments, clip 1.0, flash attention) through the two-pass
    step and through the fused step (micro step + apply step) from the
    same weights. The raw gradient norms agree to 1e-3 relative, and the
    updates (new minus old weights) to 5e-2 of the fused update's L2 norm:
    the convolutions' backward on the card need not give the same bits
    twice, and Adam's first step moves a weight by about 3.63 lr times the
    sign of its gradient, so a gradient near zero that flips sign moves its
    weight by twice that. Prints the largest difference."""
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE
    from aozora_sdxl_training_tpu_torch.models.sdxl.unet import init_params
    from aozora_sdxl_training_tpu_torch.opt import adamw
    from aozora_sdxl_training_tpu_torch.train import train_step as ts
    g = torch.Generator(device=cuda_device).manual_seed(1234)
    base = init_params(SDXL_BASE, g, dtype=torch.bfloat16)
    cfg = ts.TrainStepConfig(unet=SDXL_BASE, grad_accum_steps=1, clip_grad_norm=1.0,
                             attn_impl="flash", compute_dtype=torch.bfloat16)
    opt_cfg = adamw.AdamWConfig.from_params_dict({"momentum_dtype": "int8_blockwise",
                                                  "debias_strength": 0.3})
    batch = (torch.randn(1, 128, 128, 4, generator=g, device=cuda_device),
             torch.randn(1, 77, SDXL_BASE.cross_attention_dim, generator=g,
                         device=cuda_device),
             torch.randn(1, SDXL_BASE.pooled_projection_dim, generator=g, device=cuda_device),
             torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]], device=cuda_device),
             torch.tensor([500], device=cuda_device), torch.ones(1, device=cuda_device),
             torch.ones(1000, device=cuda_device))
    lr = 1e-3
    results = {}
    for kind in ("fused", "two_pass"):
        trainable = {n: p.clone().requires_grad_(True) for n, p in base.items()}
        state = adamw.init_state(trainable, opt_cfg)
        if kind == "fused":
            loss, _ = ts.make_micro_step(cfg)(trainable, {}, *batch, 7, 1, 0.0)
            raw, _ = ts.make_apply_step(cfg, opt_cfg)(trainable, state, lr)
        else:
            loss, _, raw, _ = ts.make_two_pass_step(ts.make_loss_fn(cfg), opt_cfg, 1.0)(
                trainable, {}, state, *batch, 7, 1, lr=lr)
        results[kind] = ({n: p.detach() for n, p in trainable.items()}, float(loss),
                         float(raw))
        del trainable, state
    (fused, loss_f, raw_f), (two, loss_t, raw_t) = results["fused"], results["two_pass"]
    diff_sq = upd_sq = 0.0
    largest, n_diff = 0.0, 0
    for name, p0 in base.items():
        upd = fused[name].float() - p0.float()
        diff = two[name].float() - fused[name].float()
        diff_sq += float((diff ** 2).sum())
        upd_sq += float((upd ** 2).sum())
        largest = max(largest, float(diff.abs().max()))
        n_diff += int((diff != 0).sum())
    rel = (diff_sq / upd_sq) ** 0.5
    n = sum(p.numel() for p in base.values())
    print(f"two-pass against fused on SDXL_BASE: loss {loss_t} / {loss_f}, raw norm "
          f"{raw_t} / {raw_f}; update difference {rel:.3e} of the fused update's norm, "
          f"largest {largest:.3e}, {n_diff} of {n} weights differ")
    assert loss_t == pytest.approx(loss_f, rel=1e-3)
    assert raw_t == pytest.approx(raw_f, rel=1e-3)
    assert rel <= 5e-2


@pytest.mark.cuda
def test_host_moments_save_and_resume_through_pinned_memory(cuda_device, tmp_path):
    """A state whose moments live in pinned host memory saves from those
    tensors (once the last step's copies into them are done) and resumes
    into pinned host memory: every moment pinned, on the host, bit for bit
    the saved one, and the restore leaves the card's allocation as it was
    but for the staging window."""
    from aozora_sdxl_training_tpu_torch.ckpt.train_state import (
        load_train_state, save_train_state)
    from aozora_sdxl_training_tpu_torch.models.sdxl import conversion
    from aozora_sdxl_training_tpu_torch.opt import adamw
    layout = adamw.Layout(conversion.to_jax_layout, conversion.from_jax_layout)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    shapes = {"conv.weight": (64, 32, 3, 3), "proj.weight": (640, 320), "norm.weight": (77,)}
    params = {n: torch.randn(s, generator=g, device=cuda_device).to(torch.bfloat16)
              for n, s in shapes.items()}
    cfg = adamw.AdamWConfig.from_params_dict({"momentum_dtype": "int8_blockwise",
                                              "min_8bit_size": 1000})
    window = 1 << 20
    state = adamw.init_state(params, cfg, layout, host_window=window)
    for step in range(2):
        grads = {n: torch.randn(p.shape, generator=g, device=cuda_device).to(torch.bfloat16)
                 for n, p in params.items()}
        adamw.apply_updates(params, grads, state, cfg, lr=1e-3 * (step + 1))
    save_train_state(tmp_path / "state.safetensors", opt_state=state, global_step=2,
                     micro_step=2, sampler_seed=5, sampler_epoch=0,
                     timestep_sampler_state=None)
    _, host = load_train_state(tmp_path / "state.safetensors", layout)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    back = adamw.restored_state(host, params, cfg, host_window=window)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - held == window
    assert back.host is not None and back.step == 2
    for (what, a), (_, b) in zip(_moment_tensors(back), _moment_tensors(state)):
        assert a.device.type == "cpu" and a.is_pinned(), what
        assert torch.equal(a, b), what
