"""PyTorch port: MIXED_PRECISION float16 on the flash route against the JAX
package.

The JAX package computes in float16 for any ``MIXED_PRECISION`` but
"bfloat16" (``config/runtime.py``), with its Pallas kernels generic in the
dtype: fp32 scores, statistics and accumulators, P and dS rounded to the
input dtype before each product, no loss scaling. The port's fp16 kernels
(the wgmma templates of ``csrc/flash_attention_sm90.cu`` built for
``__half``, and K6 in fp16) run on the card only; here, on the CPU, the
port's wrappers run their plain versions on fp16 tensors (fp32 math, the
result rounded to fp16), and the JAX side runs its Pallas kernels in
interpret mode, as its own tests do. The same numpy inputs go into both.

* flash attention at head_dim 64 (``_flash_forward``) and 128 (the folded
  kernels), forward and vjp: within 2 fp16 ulps of the largest magnitude
  of each output (the JAX kernels round P and dS to fp16 before their
  products; the plain version keeps them in fp32);
* K5's ``flash_fwd_stats`` / ``flash_bwd_stats`` on a KV shard, the same bar;
* K6 (``group_norm_silu(use_pallas=True)``) forward and gradients: 5e-3 of
  the largest magnitude (one fp16 rounding, 2^-11, with room);
* a TINY SDXL micro and apply step and a TINY Anima micro step in fp16 on
  the flash route (``AOZORA_FLASH_MIN_KV`` lowered so that the
  self-attention takes it), weights through ``params_from_jax``: the
  tolerances are stated in each test;
* both TINY CLIs with ``MIXED_PRECISION`` float16 and the flash route
  forced: each completes with finite losses and saves an F16 model with the
  keys and dtypes the JAX package's save writes for it.

The port's side of every test runs torch on one CPU thread
(``tests/test_torch_port_trainer.py::one_thread``).
"""

import contextlib
import io
import json
import re
from dataclasses import replace
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aozora_sdxl_training_tpu.ckpt import anima_checkpoint as jax_anima_ckpt
from aozora_sdxl_training_tpu.ckpt import sd_checkpoint as jax_sd_ckpt
from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.models.sdxl.arch import TINY
from aozora_sdxl_training_tpu.ops import flash_attention as jax_fa
from aozora_sdxl_training_tpu.ops import groupnorm_silu as jax_gn
from aozora_sdxl_training_tpu.opt import adamw as jax_adamw
from aozora_sdxl_training_tpu.train import anima_trainer as jax_anima
from aozora_sdxl_training_tpu.train import objectives as jax_obj
from aozora_sdxl_training_tpu.train import train_step as jax_ts
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import read_header
from aozora_sdxl_training_tpu_torch.cli import train_anima as port_anima_cli
from aozora_sdxl_training_tpu_torch.cli import train_sdxl as port_sdxl_cli
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.models.sdxl.arch import TINY as PORT_TINY
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import params_from_jax
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port_fa
from aozora_sdxl_training_tpu_torch.ops import groupnorm_silu as port_gn
from aozora_sdxl_training_tpu_torch.opt import adamw as port_adamw
from aozora_sdxl_training_tpu_torch.train import anima_trainer as port_anima
from aozora_sdxl_training_tpu_torch.train import train_step as port_ts
from aozora_sdxl_training_tpu_torch.train import trainer as port_trainer

from tests import test_torch_port_anima_trainer as anima_env
from tests import test_torch_port_trainer as sdxl_env
from tests.test_torch_port_anima_dit import numpy_params as dit_numpy_params
from tests.test_torch_port_trainer import one_thread
from tests.test_torch_port_unet import numpy_params as unet_numpy_params

F16 = torch.float16


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    with one_thread():
        yield


def _fp16_ulp(x) -> float:
    """One fp16 ulp at the largest magnitude of ``x`` (2^-10 of its binade)."""
    top = float(np.abs(np.asarray(x, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 10)


def _within_ulps(got, want, ulps, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all(), name
    assert err <= ulps * _fp16_ulp(want), (name, err, _fp16_ulp(want))


def _rand16(rng, *shape):
    return rng.normal(size=shape).astype(np.float16)


# --------------------------------------------------------------------------
# Kernels: flash attention (K1-K4b), K5, K6
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_fp16_matches_jax_kernels(d):
    """B=1, S=256, H=2, unit-normal fp16 inputs: the JAX flash_attention
    (``_flash_forward`` at 64, the folded kernels at 128, interpreted) and
    its vjp against the port's ``flash_attention`` and its backward (the
    plain version on fp16 CPU tensors): out, dq, dk and dv within 2 fp16
    ulps of their largest magnitude."""
    rng = np.random.default_rng(d)
    q, k, v, tangent = (_rand16(rng, 1, 256, 2, d) for _ in range(4))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fa.flash_attention, *map(jnp.asarray, (q, k, v)))
        want_grads = vjp(jnp.asarray(tangent))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = port_fa.flash_attention(qt, kt, vt)
    out.backward(torch.from_numpy(tangent))
    assert out.dtype == F16 and qt.grad.dtype == F16
    _within_ulps(out.detach(), want, 2, "out")
    for name, got, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want_grads):
        _within_ulps(got, w, 2, name)


def test_stats_entry_points_fp16_match_jax():
    """K5 at head_dim 128 in fp16: the forward on the second of three KV
    shards, the backward on it with the global (out, lse) of all the keys;
    out, dq, dk and dv within 2 fp16 ulps of their largest magnitude, lse
    (fp32) within 1e-3."""
    rng = np.random.default_rng(5)
    q, do = _rand16(rng, 1, 48, 2, 128), _rand16(rng, 1, 48, 2, 128)
    k, v = _rand16(rng, 1, 96, 2, 128), _rand16(rng, 1, 96, 2, 128)
    ks, vs = k[:, 32:64], v[:, 32:64]
    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = jax_fa.flash_fwd_stats(*map(jnp.asarray, (q, ks, vs)))
        g_out, g_lse = (np.array(x) for x in jax_fa.flash_fwd_stats(*map(jnp.asarray, (q, k, v))))
        want = jax_fa.flash_bwd_stats(*map(jnp.asarray, (q, ks, vs, g_out, g_lse, do)))
    out, lse = port_fa.flash_fwd_stats(*map(torch.from_numpy, (q, ks, vs)))
    assert out.dtype == F16 and lse.dtype == torch.float32
    _within_ulps(out, want_out, 2, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-3)
    got = port_fa.flash_bwd_stats(*map(torch.from_numpy, (q, ks, vs, g_out, g_lse, do)))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == F16, name
        _within_ulps(a, w, 2, name)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8), ((1, 5, 7, 320), 32)])
def test_group_norm_silu_fp16_matches_jax(shape, groups):
    """K6's op (``use_pallas=True``: the kernel's plain version here, the
    interpreted Pallas kernel in JAX) on fp16 x, fp32 scale and bias:
    output and the gradients of x, scale and bias within 5e-3 of their
    largest magnitude."""
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = (0.5 + rng.normal(size=shape)).astype(np.float16)
    scale = (1.0 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.2 * rng.normal(size=(c,))).astype(np.float32)
    tangent = rng.normal(size=shape).astype(np.float32)

    def loss(xj, s, b):
        out = jax_gn.group_norm_silu(xj, s, b, groups=groups, use_pallas=True)
        return jnp.sum(out.astype(jnp.float32) * tangent), out

    grads, want = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x, scale, bias)))
    xt, st, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias))
    out = port_gn.group_norm_silu(xt, st, bt, groups=groups, use_pallas=True)
    (out.float() * torch.from_numpy(tangent)).sum().backward()
    assert out.dtype == F16 and xt.grad.dtype == F16
    for name, got, w in zip(("out", "dx", "dscale", "dbias"),
                            (out.detach(), xt.grad, st.grad, bt.grad), (want, *grads)):
        got, w = got.float().numpy(), np.asarray(w, np.float32)
        assert np.abs(got - w).max() <= 5e-3 * np.abs(w).max(), name


# --------------------------------------------------------------------------
# The steps: TINY SDXL micro + apply, TINY Anima micro
# --------------------------------------------------------------------------

def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# TINY cut to two levels of one block each: the JAX step's compile (about
# 20 s for this UNet on the CPU, TINY's three levels half again) is most of
# the test's time
SMALL_UNET = dict(block_out_channels=(32, 64), transformer_layers=(0, 1), num_heads=(2, 4),
                  mid_transformer_layers=1, layers_per_block=1)


def test_sdxl_fp16_micro_and_apply_steps_match_jax(monkeypatch):
    """Two micro steps (GA 2, batch 2, 8 x 8 latents) and one apply step of
    a small UNet (TINY's widths, two levels) in fp16 on the flash route
    (every self-attention: its KV of 16 tokens reaches the lowered
    AOZORA_FLASH_MIN_KV of 16; the cross-attention's 10 stay on einsum),
    fp32 masters. Both packages round
    fp16 at different places (XLA fusions against eager ops): losses within
    2e-3 relative; the accumulated gradient, as one vector, within 1e-2
    relative L2 of JAX's; the update (new - old weights), as one vector, at
    a cosine of at least 0.99 with JAX's and the same norm within 1% (Adam's
    first step moves nearly every element by a full step whatever its
    gradient's size; where fp16 noise flips a tiny gradient's sign the step
    flips too)."""
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", "16")
    cfg, pcfg = replace(TINY, **SMALL_UNET), replace(PORT_TINY, **SMALL_UNET)
    rng = np.random.default_rng(17)
    np_params = unet_numpy_params(cfg, rng)
    b, hw, seq, ga, lr = 2, 8, 10, 2, 1e-4
    batches = [dict(
        latents=rng.normal(size=(b, hw, hw, 4)).astype(np.float32) * 0.2,
        embeds=rng.normal(size=(b, seq, cfg.cross_attention_dim)).astype(np.float32),
        pooled=rng.normal(size=(b, cfg.pooled_projection_dim)).astype(np.float32),
        time_ids=np.tile(np.asarray([64, 64, 0, 0, 64, 64], np.float32), (b, 1)),
        timesteps=rng.integers(0, 1000, size=(b,)).astype(np.int32),
        sample_mask=np.ones((b,), np.float32)) for _ in range(ga)]
    noise = rng.normal(size=(ga + 1, b, hw, hw, 4)).astype(np.float32)
    weights = np.ones((1000,), np.float32)

    trainable, frozen = jax_ts.split_trainable(
        {k: jnp.asarray(v) for k, v in np_params.items()}, ["conv1", "conv2"])
    step_cfg = jax_ts.TrainStepConfig(unet=cfg, prediction_type="v_prediction",
                                      grad_accum_steps=ga, clip_grad_norm=1.0,
                                      attn_impl="flash", compute_dtype=jnp.float16, remat=False)
    opt_cfg = jax_adamw.AdamWConfig(debias_strength=0.3, momentum_dtype=jnp.float32)
    table = jnp.asarray(noise)
    monkeypatch.setattr(jax_obj, "noise_for_step", lambda seed, ms, shape: table[ms])
    with pltpu.force_tpu_interpret_mode():
        micro = jax.jit(jax_ts.make_micro_step(step_cfg))
        accum, want_losses = jax_ts.zero_grad_accum(trainable), []
        for i, bt in enumerate(batches, start=1):
            loss, _, accum = micro(trainable, frozen, accum, bt["latents"], bt["embeds"],
                                   bt["pooled"], bt["time_ids"], bt["timesteps"],
                                   bt["sample_mask"], jnp.asarray(weights), 11, i,
                                   0.0 if i == 1 else 1.0)
            want_losses.append(float(loss))
        new, _, _, _ = jax.jit(jax_ts.make_apply_step(step_cfg, opt_cfg))(
            trainable, accum, jax_adamw.init_state(trainable, opt_cfg), lr)
    want_accum = params_from_jax({k: np.asarray(v) for k, v in accum.items()})
    want_new = params_from_jax({k: np.asarray(v) for k, v in new.items()})

    params = params_from_jax(np_params)
    p_train, p_frozen = port_ts.split_trainable(params, ["conv1", "conv2"])
    for p in p_train.values():
        p.requires_grad_(True)
    p_cfg = port_ts.TrainStepConfig(unet=pcfg, prediction_type="v_prediction",
                                    grad_accum_steps=ga, clip_grad_norm=1.0, attn_impl="flash",
                                    compute_dtype=F16)
    calls = []
    real = port_fa.FlashAttention.apply
    monkeypatch.setattr(port_fa.FlashAttention, "apply",
                        lambda q, *a: calls.append(q.dtype) or real(q, *a))
    p_micro = port_ts.make_micro_step(p_cfg)
    losses = []
    for i, bt in enumerate(batches, start=1):
        bt = {k: torch.from_numpy(v) for k, v in bt.items()}
        loss, _ = p_micro(p_train, p_frozen, bt["latents"], bt["embeds"], bt["pooled"],
                          bt["time_ids"], bt["timesteps"], bt["sample_mask"],
                          torch.from_numpy(weights), 11, i, 0.0 if i == 1 else 1.0,
                          noise=torch.from_numpy(noise[i]))
        losses.append(float(loss))
    assert calls and set(calls) == {F16}
    old = {n: p.detach().clone() for n, p in p_train.items()}
    got_accum = {n: p.grad / ga for n, p in p_train.items()}   # JAX accumulates the mean
    port_ts.make_apply_step(p_cfg, port_adamw.AdamWConfig(
        debias_strength=0.3, momentum_dtype=torch.float32))(
        p_train, port_adamw.init_state(p_train, port_adamw.AdamWConfig(
            debias_strength=0.3, momentum_dtype=torch.float32)), lr)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-3)
    names = sorted(p_train)
    cat = lambda d: np.concatenate([d[n].detach().numpy().ravel() for n in names])  # noqa: E731
    got_upd = cat({n: p_train[n] - old[n] for n in names})
    want_upd = cat({n: want_new[n] - old[n] for n in names})
    assert _rel_l2(cat(got_accum), cat(want_accum)) <= 1e-2
    assert np.linalg.norm(got_upd) == pytest.approx(np.linalg.norm(want_upd), rel=1e-2)
    assert _cosine(got_upd, want_upd) >= 0.99


def test_anima_fp16_micro_step_matches_jax(monkeypatch):
    """One micro step of a TINY DiT with head_dim 128 (two blocks, 2 heads
    of 128) in fp16 on the flash route (the self-attention's 64 tokens reach
    the lowered AOZORA_FLASH_MIN_KV of 64; the adapter's and the
    cross-attention's 12 and 16 stay on einsum), Full remat, fp32 masters:
    the loss within 2e-3 relative of JAX's and the gradient, as one vector,
    within 1e-2 relative L2 (fp16 rounded at different places)."""
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", "64")
    cfg = replace(jax_dit.TINY_ANIMA, model_channels=256, num_heads=2, num_blocks=2)
    pcfg = replace(port_dit.TINY_ANIMA, model_channels=256, num_heads=2, num_blocks=2)
    rng = np.random.default_rng(23)
    np_params = dit_numpy_params(cfg, rng)
    lat = (0.3 * rng.normal(size=(1, 16, 16, cfg.in_channels))).astype(np.float32)
    prompt = rng.normal(size=(1, 12, cfg.adapter_source_dim)).astype(np.float32)
    ids = rng.integers(1, cfg.adapter_vocab, (1, 12)).astype(np.int32)
    tickets = np.asarray([370], np.int32)
    noise = rng.normal(size=lat.shape).astype(np.float32)
    weights = np.ones((1000,), np.float32)

    monkeypatch.setattr(jax_obj, "noise_for_step", lambda seed, ms, shape: jnp.asarray(noise))
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    # remat=False on the JAX side: its remat does not take the interpreted
    # kernels' callbacks; the gradient is the same function
    micro = jax_anima.make_anima_micro_step(cfg, grad_accum_steps=1, compute_dtype=jnp.float16,
                                            attn_impl="flash", remat=False)
    with pltpu.force_tpu_interpret_mode():
        want_loss, _, accum = jax.jit(micro)(
            params, {}, jax.tree.map(jnp.zeros_like, params), jnp.asarray(lat),
            jnp.asarray(prompt), jnp.asarray(ids), jnp.asarray(tickets),
            jnp.ones((1,), jnp.float32), None, jnp.asarray(weights), jnp.asarray(7, jnp.int32),
            jnp.asarray(1, jnp.int32), jnp.asarray(0.0, jnp.float32))
    want_grads = port_dit.params_from_jax({k: np.asarray(v) for k, v in accum.items()})

    trainable = port_dit.params_from_jax(np_params)
    for p in trainable.values():
        p.requires_grad_(True)
    calls = []
    real = port_fa.FlashAttention.apply
    monkeypatch.setattr(port_fa.FlashAttention, "apply",
                        lambda q, *a: calls.append(q.dtype) or real(q, *a))
    step = port_anima.make_anima_micro_step(port_anima.AnimaStepConfig(
        dit=pcfg, attn_impl="flash", compute_dtype=F16, remat=True))
    loss, _ = step(trainable, {}, torch.from_numpy(lat), torch.from_numpy(prompt),
                   torch.from_numpy(ids), torch.from_numpy(tickets), torch.ones(1),
                   torch.from_numpy(weights), 7, 1, 0.0, noise=torch.from_numpy(noise))
    assert calls and set(calls) == {F16}
    assert float(loss) == pytest.approx(float(want_loss), rel=2e-3)
    names = sorted(trainable)
    got = np.concatenate([trainable[n].grad.numpy().ravel() for n in names])
    want = np.concatenate([want_grads[n].numpy().ravel() for n in names])
    assert np.isfinite(got).all() and _rel_l2(got, want) <= 1e-2


# --------------------------------------------------------------------------
# The CLIs
# --------------------------------------------------------------------------

def _losses(out: str) -> list:
    return [float(m) for m in re.findall(r"\[Loss:\s*([\d.e+-]+),", out)]


@contextlib.contextmanager
def _flash_forced(monkeypatch, min_kv: int):
    """The trainers' attention route forced to flash on the CPU (where it is
    einsum), the KV threshold lowered, and the flash entry's calls
    recorded by input dtype."""
    monkeypatch.setattr(port_trainer, "attention_impl", lambda config, device: "flash")
    monkeypatch.setattr(port_anima, "attention_impl", lambda config, device: "flash")
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", str(min_kv))
    monkeypatch.setenv("AOZORA_PLATFORM", "cpu")
    monkeypatch.setenv("AOZORA_DEVICES", "1")
    calls = []
    real = port_fa.FlashAttention.apply
    monkeypatch.setattr(port_fa.FlashAttention, "apply",
                        lambda q, *a: calls.append(q.dtype) or real(q, *a))
    yield calls


def _header(path: Path) -> dict:
    return {k: (v["dtype"], tuple(v["shape"])) for k, v in read_header(path).items()}


def test_sdxl_cli_in_fp16_on_the_flash_route(tmp_path, monkeypatch):
    """The SDXL CLI (TINY, GA 2, 4 micro steps) with MIXED_PRECISION
    float16: the flash entry sees fp16 tensors, the losses are finite, and
    the merged model holds every key of the JAX package's save of the same
    base in float16, with its dtype (F16 for every float tensor) and
    shape."""
    sdxl_env._build_env(tmp_path)
    flat = sdxl_env._flat(tmp_path, "out", MIXED_PRECISION="float16")
    preset = tmp_path / "fp16.json"
    preset.write_text(json.dumps(schema.nest_flat_config(flat, "sdxl")))
    out = io.StringIO()
    with _flash_forced(monkeypatch, 16) as calls, contextlib.redirect_stdout(out), \
            mock.patch.object(port_trainer, "check_if_caching_needed", return_value=False):
        port_sdxl_cli.main(["--config", str(preset)])
    losses = _losses(out.getvalue())
    assert len(losses) == sdxl_env.STEPS and all(np.isfinite(losses))
    assert calls and set(calls) == {F16}
    np_params = unet_numpy_params(TINY, np.random.default_rng(21))  # _build_env's weights
    jax_sd_ckpt.save_merged_checkpoint(tmp_path / "jax_fp16.safetensors",
                                       {k: jnp.asarray(v) for k, v in np_params.items()},
                                       TINY, tmp_path / "base.safetensors", jnp.float16)
    got, want = _header(tmp_path / "out" / "run.safetensors"), _header(
        tmp_path / "jax_fp16.safetensors")
    assert got == want
    assert {dtype for dtype, _ in got.values()} == {"F16"}


def test_anima_cli_in_fp16_on_the_flash_route(tmp_path, monkeypatch):
    """The Anima CLI (TINY DiT, GA 2, 4 micro steps) with MIXED_PRECISION
    float16: the flash entry sees fp16 tensors, the losses are finite, and
    the saved DiT has the keys (under the detected prefix), F16 dtypes and
    shapes of the JAX package's save of the same weights in float16."""
    np_params = anima_env._build_env(tmp_path)
    flat = anima_env._flat(tmp_path, "out", MIXED_PRECISION="float16")
    preset = tmp_path / "fp16.json"
    preset.write_text(json.dumps(schema.nest_flat_config(flat, "anima")))
    out = io.StringIO()
    with _flash_forced(monkeypatch, 16) as calls, contextlib.redirect_stdout(out), \
            mock.patch.object(port_anima, "check_if_anima_caching_needed",
                              return_value=False):
        port_anima_cli.main(["--config", str(preset)])
    losses = _losses(out.getvalue())
    assert len(losses) == anima_env.STEPS and all(np.isfinite(losses))
    assert calls and set(calls) == {F16}
    jax_anima_ckpt.save_dit_model(
        tmp_path / "jax_fp16.safetensors",
        {k: np.asarray(v) for k, v in jax_dit.params_to_torch_state(
            {k: jnp.asarray(v) for k, v in np_params.items()}).items()},
        prefix="pipe.dit.", dtype=jnp.float16)
    got, want = _header(tmp_path / "out" / "anima_run.safetensors"), _header(
        tmp_path / "jax_fp16.safetensors")
    assert got == want
    assert {dtype for dtype, _ in got.values()} == {"F16"}
