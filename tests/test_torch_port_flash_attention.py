"""PyTorch port: flash attention against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as
tests/test_flash_attention.py does. Same numpy inputs into both, fp32.
Forward tolerance 2e-4 and gradient tolerance 5e-4 are the JAX package's
own bars for its kernel against its XLA reference.

The CUDA kernels themselves are checked against the plain version on the
card by ``chip_smoke.py`` and by tests/test_torch_port_cuda.py. What runs
without a card is checked here too: which library each kernel is bound
from, the nvcc command of the wgmma source, the rebuild rule, and the
wrappers' alignment check (tests/test_torch_port_flash_routes.py holds the
routing by head dim, dtype and role). The arithmetic of the fp32 kernels
(3xTF32: each operand split into two TF32 parts, three TF32 products; the
forward at head_dim 64, 128 and 512, the backward at 64 and 128) is
emulated here in each kernel's loop and held against the JAX kernels in
fp32 at a bar that one TF32 product does not meet.
"""

import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aozora_sdxl_training_tpu.ops.flash_attention import (
    LANES, _flash_backward, _flash_backward_folded, _flash_forward, _flash_forward_folded,
    _pick_blocks, _round_up, flash_attention as jax_flash, flash_fwd_stats)
from aozora_sdxl_training_tpu_torch.ops import cuda_build
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port
from aozora_sdxl_training_tpu_torch.ops.attention import attention

from tests.test_torch_port_trainer import one_thread


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


def _inputs(seed, sq, skv, b=1, h=2, d=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32))


@pytest.mark.parametrize("sq,skv", [(256, 256), (160, 160), (256, 77)])
def test_forward_and_lse_match_jax_kernel(sq, skv):
    q, k, v = _inputs(sq + skv, sq, skv)
    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_lse = flash_fwd_stats(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    out, lse = port.flash_attention_lse(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sq,skv", [(256, 128), (128, 77)])
def test_gradients_match_jax_grad(sq, skv):
    q, k, v = _inputs(7 * sq + skv, sq, skv)
    tangent = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jax_flash(q, k, v) * tangent)

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (port.flash_attention(qt, kt, vt) * torch.from_numpy(tangent)).sum().backward()
    for got, want, name in zip((qt.grad, kt.grad, vt.grad), g_ref, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4, err_msg=name)


def test_dispatch_rule(monkeypatch):
    """flash only for impl="flash" and KV >= FLASH_MIN_KV (env-overridable);
    both paths agree with each other."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 64, 64))
    calls = []
    real = port.FlashAttention.apply

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(port.FlashAttention, "apply", spy)
    einsum = attention(q, k, v, impl="flash")          # KV 64 < 1024
    assert calls == []
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", "64")
    flash = attention(q, k, v, impl="flash")
    assert len(calls) == 1
    attention(q, k, v, impl="xla")
    assert len(calls) == 1
    np.testing.assert_allclose(flash.numpy(), einsum.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A wrapper takes the plain path only for CPU tensors: any other
    device that is not CUDA raises before any launch."""
    q = torch.zeros(1, 8, 1, 32, device="meta")
    with pytest.raises(ValueError):
        port.flash_fwd(q, q, q, 1.0)


def test_each_kernel_is_bound_from_the_library_of_its_source(monkeypatch):
    """The wgmma entry points (all of head_dim 64 and 128 and the bf16
    head_dim-512 forward) come from csrc/flash_attention_sm90.cu (and only
    its library is loaded for them, with their argument types); the fp32
    ones from csrc/flash_attention_fp32.cu. A launch goes to the library of
    its kernel."""
    assert set(port.SOURCES.values()) == {"flash_attention_sm90", "flash_attention_fp32"}
    assert set(port.SOURCES) == {kernel[0] for kernels in port.ROUTES.values()
                                 for kernel in kernels if kernel}
    loaded, called = [], []

    def entry(source, name):
        def fn(*args):
            called.append((source, name, args))
            return 0
        return fn

    def fake_load(source):
        loaded.append(source)
        names = [n for n, src in port.SOURCES.items() if src == source]
        return types.SimpleNamespace(
            aozora_flash_error_string=types.SimpleNamespace(),
            **{f"aozora_{n}": entry(source, n) for n in names})

    monkeypatch.setattr(port, "_libs", {})
    monkeypatch.setattr(port, "LAUNCHES", dict.fromkeys(port.LAUNCHES, 0))
    monkeypatch.setattr(cuda_build, "load", fake_load)
    lib = port._library("flash_attention_sm90")
    assert loaded == ["flash_attention_sm90"]
    for names in ([name for name, _ in port.ROUTES[128, torch.bfloat16]],
                  ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), ("flash_fwd_d512",)):
        for name, types_ in zip(names, port._ARGTYPES):
            assert getattr(lib, f"aozora_{name}").argtypes == types_
    assert not hasattr(lib, "aozora_flash_fwd_f32_d512")
    assert port._library("flash_attention_sm90") is lib and len(loaded) == 1
    port._launch("flash_bwd_dkv_d128", 7)
    port._launch("flash_fwd_d512", 8)
    port._launch("flash_fwd_f32_d512", 9)
    assert called == [("flash_attention_sm90", "flash_bwd_dkv_d128", (7,)),
                      ("flash_attention_sm90", "flash_fwd_d512", (8,)),
                      ("flash_attention_fp32", "flash_fwd_f32_d512", (9,))]
    assert loaded == ["flash_attention_sm90", "flash_attention_fp32"]
    assert {k: v for k, v in port.LAUNCHES.items() if v} == {
        "flash_bwd_dkv_d128": 1, "flash_fwd_d512": 1, "flash_fwd_f32_d512": 1}


def test_build_command_of_the_sm90_source(monkeypatch, tmp_path):
    """One nvcc call for sm_90a with the ptxas report; the source includes
    the wgmma header that lives beside it. No driver library is linked (the
    kernels load with cp.async, not TMA descriptors)."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    cmd = cuda_build.build_command("flash_attention_sm90")
    assert cmd[0] == str(nvcc)
    assert cmd[-1] == str(cuda_build.CSRC / "flash_attention_sm90.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd and ["-Xptxas", "-v"] == cmd[
        cmd.index("-Xptxas"):cmd.index("-Xptxas") + 2]
    assert cmd[cmd.index("-o") + 1].endswith("flash_attention_sm90.so.tmp")
    assert "-lcuda" not in cmd
    source = (cuda_build.CSRC / "flash_attention_sm90.cu").read_text()
    assert '#include "sm90_wgmma.cuh"' in source
    assert cuda_build.CSRC / "sm90_wgmma.cuh" in cuda_build.inputs("flash_attention_sm90")


def test_a_library_is_rebuilt_when_its_source_or_any_header_is_newer(monkeypatch,
                                                                     tmp_path):
    csrc, build = tmp_path / "csrc", tmp_path / "csrc" / "build"
    (csrc / "sub").mkdir(parents=True)
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    cu, cuh, h, lib = (csrc / "k.cu", csrc / "k.cuh", csrc / "sub" / "x.h", build / "k.so")
    for path in (cu, cuh, h, csrc / "notes.txt"):
        path.write_text("")
    assert cuda_build.needs_build("k")            # no library yet
    lib.write_text("")
    for path in (cu, cuh, h, csrc / "notes.txt"):
        os.utime(path, (100, 100))
    os.utime(lib, (200, 200))
    assert not cuda_build.needs_build("k")
    assert cuda_build.inputs("k") == [cu, cuh, h]
    for newer in (cu, cuh, h):
        os.utime(newer, (300, 300))
        assert cuda_build.needs_build("k"), newer.name
        os.utime(newer, (100, 100))
    os.utime(csrc / "notes.txt", (300, 300))       # not an input
    assert not cuda_build.needs_build("k")


def test_unaligned_tensor_is_refused():
    base = torch.zeros(4 * 128 + 8, dtype=torch.bfloat16)
    bad = base[1:4 * 128 + 1].view(1, 4, 1, 128)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        port._check_aligned("q", bad)
    port._check_aligned("q", base[8:].view(1, 4, 1, 128))    # 16 bytes in


def test_a_forced_build_rebuilds_a_current_library(monkeypatch, tmp_path):
    """build_all starts nvcc only for stale libraries unless forced (as
    chip_smoke.py's build phase does, so the ptxas report it prints is that
    run's); finish_build moves the new library into place and returns
    nvcc's output."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    started = []

    def fake_popen(cmd, **kwargs):
        out = Path(cmd[cmd.index("-o") + 1])
        started.append(out.name)
        out.write_text("new")
        return types.SimpleNamespace(returncode=0,
                                     communicate=lambda: ("ptxas info: Used 9 registers", None))

    monkeypatch.setattr(cuda_build.subprocess, "Popen", fake_popen)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "needs_build", lambda name: False)
    assert cuda_build.build_all(["k"])["k"][1] == "" and started == []
    result = cuda_build.build_all(["k"], force=True)
    assert started == ["k.so.tmp"] and result["k"][1] == "ptxas info: Used 9 registers"
    assert cuda_build.library_path("k").read_text() == "new"
    failed = types.SimpleNamespace(returncode=1, communicate=lambda: ("error", None))
    with pytest.raises(RuntimeError, match="nvcc failed for k.cu"):
        cuda_build.finish_build("k", failed)


# --------------------------------------------------------------------------
# The fp32 kernels' 3xTF32 arithmetic, emulated
# --------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, at the 13th mantissa bit, the low 13 bits cleared (the
    integer form of flash_attention_fp32.cu)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x as the tensor cores read a TF32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, products):
    """a @ b from TF32 operands with fp32 sums: hi hi alone (products=1), or
    lo hi + hi lo + hi hi (3), hi = tf32(x) and lo = x - hi as the tensor
    cores read it, as the kernel splits them."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_attention(q, k, v, scale, products, block_k, quarters):
    """The forward kernels' loop on (S, D) fp32 rows: each block_k-key tile
    split into ``quarters`` runs of keys, each run with an online softmax of
    its own over its keys of every tile (the scores in TF32 products, m and
    l in fp32, O += P V in TF32 products), the runs merged at the end in
    order. At head_dim 512: 16-key tiles, one run; at 64 and 128: 64-key
    tiles, one run of 16 keys for each of a row group's 4 warps."""
    width = block_k // quarters
    runs = []
    for run in range(quarters):
        m = torch.full((q.shape[0],), -1e30)
        l = torch.zeros(q.shape[0])
        o = torch.zeros_like(q)
        for j0 in range(run * width, k.shape[0], block_k):
            s = _tf32_matmul(q, k[j0:j0 + width].T, products) * scale
            m_new = torch.maximum(m, s.max(1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None])
            l = l * alpha + p.sum(1)
            o = o * alpha[:, None] + _tf32_matmul(p, v[j0:j0 + width], products)
            m = m_new
        runs.append((m, l, o))
    m = torch.stack([r[0] for r in runs]).max(0).values
    l, o = torch.zeros_like(m), torch.zeros_like(q)
    for m_r, l_r, o_r in runs:
        w = torch.exp(m_r - m)
        l, o = l + l_r * w, o + o_r * w[:, None]
    return o / l[:, None], m + torch.log(l)


def _jax_kernels(q, k, v, do, scale):
    """out, lse and, for ``do`` not None, dq, dk and dv of the JAX package's
    Pallas kernels in fp32 (interpret mode) on one head of (S, D) rows:
    _flash_forward and _flash_backward at head_dim 64, the folded ones
    (lane-aligned heads) at 128 and 512."""
    s, d = q.shape
    block_q, block_k = _pick_blocks(s, s)
    pad = _round_up(s, block_q)

    def lay(x):
        return jnp.pad(jnp.asarray(x).reshape(1, s, d), ((0, 0), (0, pad - s), (0, 0)))

    blocks = dict(scale=scale, kv_valid=s, block_q=block_q, block_k=block_k)
    folded = {} if d == 64 else dict(h=1)
    forward = _flash_forward if d == 64 else _flash_forward_folded
    backward = _flash_backward if d == 64 else _flash_backward_folded
    with pltpu.force_tpu_interpret_mode():
        out, lse = forward(lay(q), lay(k), lay(v), **folded, **blocks)
        grads = (() if do is None else
                 backward(lay(q), lay(k), lay(v), out, lse, lay(do), **folded, **blocks))
    assert lse.shape[-1] == LANES
    return (np.array(out)[0, :s], np.array(lse)[0, :s, 0], [np.array(g)[0, :s] for g in grads])


# (head dim, tokens, block_k, quarters) of the forward kernels: the head_dim-
# 512 kernel's 16-key tiles, the 64/128 kernel's 64-key tiles in 4 runs
FORWARDS = [(64, 192, 64, 4), (128, 192, 64, 4), (512, 192, 16, 1)]


@pytest.mark.parametrize("d,s,block_k,quarters", FORWARDS, ids=[f"d{f[0]}" for f in FORWARDS])
def test_split_tf32_forward_matches_jax_kernel(d, s, block_k, quarters):
    """3xTF32 attention (one head, 192 tokens) in the loop of the fp32
    forward kernel at its head dim against the JAX package's forward kernel
    in fp32 (interpret mode): within 1e-5 of the largest output magnitude
    (lse 1e-5 absolute), where one TF32 product alone misses that bar by
    more than 10x and 3xTF32 lands near fp32's own summation error (about
    1e-6)."""
    q, k, v = _inputs(d, s, s, h=1, d=d)
    scale = d ** -0.5
    ref, ref_lse, _ = _jax_kernels(q[0, :, 0], k[0, :, 0], v[0, :, 0], None, scale)
    bar = 1e-5 * np.abs(ref).max()
    errs = {}
    for products in (1, 3):
        got, got_lse = _tf32_attention(*(torch.from_numpy(x[0, :, 0]) for x in (q, k, v)),
                                       scale, products, block_k, quarters)
        errs[products] = (np.abs(got.numpy() - ref).max(),
                          np.abs(got_lse.numpy() - ref_lse).max())
    assert errs[3][0] <= bar and errs[3][1] <= 1e-5, errs
    assert errs[1][0] > 10 * bar, errs


def _tf32_backward(q, k, v, o, do, lse, scale, products, block=32):
    """The 3xTF32 backward kernels' loops on (S, D) fp32 rows: the dQ kernel
    over 32-key tiles, the dK/dV kernel over 32-query tiles; each tile's
    products (scores and accumulating ones) in TF32 products, added into the
    running dq, dk, dv in fp32; P, dS and delta in fp32."""
    delta = (do * o).sum(1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for j0 in range(0, k.shape[0], block):
        kt, vt = k[j0:j0 + block], v[j0:j0 + block]
        p = torch.exp(_tf32_matmul(q, kt.T, products) * scale - lse[:, None])
        ds = p * (_tf32_matmul(do, vt.T, products) - delta[:, None]) * scale
        dq = dq + _tf32_matmul(ds, kt, products)
    for i0 in range(0, q.shape[0], block):
        qt, dot = q[i0:i0 + block], do[i0:i0 + block]
        pt = torch.exp(_tf32_matmul(k, qt.T, products) * scale - lse[None, i0:i0 + block])
        dv = dv + _tf32_matmul(pt, dot, products)
        dst = pt * (_tf32_matmul(v, dot.T, products) - delta[None, i0:i0 + block]) * scale
        dk = dk + _tf32_matmul(dst, qt, products)
    return dq, dk, dv


@pytest.mark.parametrize("d", [64, 128])
def test_split_tf32_backward_matches_jax_kernel(d):
    """3xTF32 dq, dk and dv (one head, 128 tokens) in the loops of the fp32
    backward kernels at head_dim ``d`` against the JAX package's backward
    kernels in fp32 (interpret mode), from its own forward's out and lse:
    within 1e-5 of each gradient's largest magnitude (about 1e-6 here),
    where one TF32 product alone misses by more than 10x that."""
    s = 128
    q, k, v = _inputs(d, s, s, h=1, d=d)
    do = np.random.default_rng(d + 1).normal(size=q.shape).astype(np.float32)
    scale = d ** -0.5
    out, lse, refs = _jax_kernels(q[0, :, 0], k[0, :, 0], v[0, :, 0], do[0, :, 0], scale)
    rows = [torch.from_numpy(x[0, :, 0]) for x in (q, k, v)]
    errs = {}
    for products in (1, 3):
        got = _tf32_backward(*rows, torch.from_numpy(out), torch.from_numpy(do[0, :, 0]),
                             torch.from_numpy(lse), scale, products)
        errs[products] = [np.abs(g.numpy() - r).max() / np.abs(r).max()
                          for g, r in zip(got, refs)]
    assert max(errs[3]) <= 1e-5, errs
    assert min(errs[1]) > 10 * 1e-5, errs
