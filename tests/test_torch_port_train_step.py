"""PyTorch port: objectives, AdamW and the micro/apply step against JAX.

Every comparison feeds both packages the same numpy inputs. The noise is
injected (the port's torch.Generator stream and JAX's threefry bits differ
by design). Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.models.sdxl.arch import TINY, param_shapes
from aozora_sdxl_training_tpu.opt import adamw as jax_adamw
from aozora_sdxl_training_tpu.train import objectives as jax_obj
from aozora_sdxl_training_tpu.train import train_step as jax_ts
from aozora_sdxl_training_tpu_torch.models.sdxl.arch import TINY as PORT_TINY
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import params_from_jax
from aozora_sdxl_training_tpu_torch.opt import adamw as port_adamw
from aozora_sdxl_training_tpu_torch.train import objectives as port_obj
from aozora_sdxl_training_tpu_torch.train import train_step as port_ts

from tests.test_torch_port_unet import numpy_params
from tests.test_torch_port_trainer import one_thread


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


# --------------------------------------------------------------------------
# Objectives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "v_prediction", "rectified_flow"])
def test_prepare_batch_and_loss_match_jax(prediction_type):
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    noise = rng.normal(size=lat.shape).astype(np.float32)
    ts = np.asarray([0, 517, 999], np.int32)
    jitter = rng.uniform(size=(3,)).astype(np.float32)
    pred = rng.normal(size=lat.shape).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=(1000,)).astype(np.float32)
    mask = np.asarray([1.0, 1.0, 0.0], np.float32)

    want = jax_obj.prepare_batch(prediction_type, jnp.asarray(lat),
                                 jnp.asarray(noise), jnp.asarray(ts),
                                 jnp.asarray(jitter))
    got = port_obj.prepare_batch(prediction_type, torch.from_numpy(lat),
                                 torch.from_numpy(noise),
                                 torch.from_numpy(ts), torch.from_numpy(jitter))
    for g, w, name in zip(got, want, ("noisy", "target", "t_cond", "sigma")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    for m in (None, mask):
        want_loss = jax_obj.weighted_mse_loss(
            jnp.asarray(pred), want[1], jnp.asarray(ts), jnp.asarray(weights),
            None if m is None else jnp.asarray(m))
        got_loss = port_obj.weighted_mse_loss(
            torch.from_numpy(pred), got[1], torch.from_numpy(ts),
            torch.from_numpy(weights), None if m is None else torch.from_numpy(m))
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-6)


def test_noise_is_keyed_by_seed_step_and_slot():
    a = port_obj.noise_for_step(42, 7, (3, 4, 4, 4))
    b = port_obj.noise_for_step(42, 7, (1, 4, 4, 4))
    np.testing.assert_array_equal(a[:1].numpy(), b.numpy())  # batch-size free
    np.testing.assert_array_equal(
        a.numpy(), port_obj.noise_for_step(42, 7, (3, 4, 4, 4)).numpy())
    assert not np.array_equal(
        a.numpy(), port_obj.noise_for_step(42, 8, (3, 4, 4, 4)).numpy())
    j = port_obj.rf_jitter_for_step(42, 3, 8).numpy()
    assert np.all((j >= 0) & (j < 1))
    np.testing.assert_array_equal(j[:2], port_obj.rf_jitter_for_step(42, 3, 2).numpy())
    np.testing.assert_array_equal(port_obj.ddpm_alphas_cumprod(),
                                  jax_obj.ddpm_alphas_cumprod())


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def test_adamw_trajectory_matches_jax_on_mixed_tree():
    """5 steps on fp32 and bf16 leaves with bf16 moments, debias 0.3 and
    weight decay, grads clipped first. fp32 leaves: rtol 1e-5 (fp32 update
    math on both sides); bf16 leaves and moments: one bf16 rounding step."""
    rng = np.random.default_rng(0)
    shapes = {"w": ((16, 8), np.float32), "b": ((33,), ml_dtypes.bfloat16),
              "n": ((5,), np.float32)}
    p0 = {k: rng.normal(size=s).astype(d) for k, (s, d) in shapes.items()}
    jcfg = jax_adamw.AdamWConfig(debias_strength=0.3, weight_decay=0.01,
                                 momentum_dtype=jnp.bfloat16)
    pcfg = port_adamw.AdamWConfig.from_params_dict(
        {"debias_strength": 0.3, "weight_decay": 0.01,
         "momentum_dtype": "bfloat16"})
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jax_adamw.init_state(jp, jcfg)

    def to_torch(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    def to_np(t):
        t = t.detach()
        return t.float().numpy()

    pp = {k: to_torch(v) for k, v in p0.items()}
    pstate = port_adamw.init_state(pp, pcfg)
    for step in range(5):
        g = {k: (rng.normal(size=s) * 3).astype(d) for k, (s, d) in shapes.items()}
        jg, jnorm = jax_adamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        pg, pnorm = port_adamw.clip_by_global_norm(
            {k: to_torch(v) for k, v in g.items()}, 1.0)
        assert float(pnorm) == pytest.approx(float(jnorm), rel=1e-6)
        lr = 1e-3 * (step + 1)
        jp, jstate, jusq = jax_adamw.apply_updates(jp, jg, jstate, jcfg, lr=lr,
                                                   return_update_sq=True)
        _, _, pusq = port_adamw.apply_updates(pp, pg, pstate, pcfg, lr=lr)
        assert float(pusq) == pytest.approx(float(jusq), rel=1e-3)
    assert pstate.step == int(jstate.step) == 5
    for k, (_, dtype) in shapes.items():
        tol = 1e-5 if dtype == np.float32 else 8e-3
        np.testing.assert_allclose(to_np(pp[k]), np.asarray(jp[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)
        np.testing.assert_allclose(to_np(pstate.exp_avg[k]),
                                   np.asarray(jstate.exp_avg[k], np.float32),
                                   rtol=8e-3, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(to_np(pstate.exp_avg_sq[k]),
                                   np.asarray(jstate.exp_avg_sq[k], np.float32),
                                   rtol=8e-3, atol=1e-9, err_msg=k)


# --------------------------------------------------------------------------
# Micro steps + apply step on the TINY UNet
# --------------------------------------------------------------------------

GA = 3
LR = 1e-4
SEED = 11


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(9)
    np_params = numpy_params(TINY, rng)
    b, hw, seq = 2, 8, 10
    batches = [dict(
        latents=rng.normal(size=(b, hw, hw, 4)).astype(np.float32) * 0.2,
        embeds=rng.normal(size=(b, seq, TINY.cross_attention_dim)).astype(np.float32),
        pooled=rng.normal(size=(b, TINY.pooled_projection_dim)).astype(np.float32),
        time_ids=np.tile(np.asarray([64, 64, 0, 0, 64, 64], np.float32), (b, 1)),
        timesteps=rng.integers(0, 1000, size=(b,)).astype(np.int32),
        sample_mask=np.ones((b,), np.float32))
        for _ in range(GA)]
    noise = rng.normal(size=(GA + 1, b, hw, hw, 4)).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, size=(1000,)).astype(np.float32)
    return np_params, batches, noise, weights


@pytest.fixture(scope="module")
def jax_step_run(step_inputs):
    np_params, batches, noise, weights = step_inputs
    trainable, frozen = jax_ts.split_trainable(
        {k: jnp.asarray(v) for k, v in np_params.items()}, ["conv1", "conv2"])
    cfg = jax_ts.TrainStepConfig(unet=TINY, prediction_type="v_prediction",
                                 grad_accum_steps=GA, clip_grad_norm=1.0,
                                 attn_impl="xla", compute_dtype=jnp.float32,
                                 remat=False)
    opt_cfg = jax_adamw.AdamWConfig(debias_strength=0.3,
                                    momentum_dtype=jnp.float32)
    table = jnp.asarray(noise)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_obj, "noise_for_step",
                   lambda seed, micro_step, shape: table[micro_step])
        micro = jax.jit(jax_ts.make_micro_step(cfg))
        accum = jax_ts.zero_grad_accum(trainable)
        losses = []
        for i, bt in enumerate(batches, start=1):
            loss, _, accum = micro(
                trainable, frozen, accum, bt["latents"], bt["embeds"],
                bt["pooled"], bt["time_ids"], bt["timesteps"],
                bt["sample_mask"], jnp.asarray(weights), SEED, i,
                0.0 if i == 1 else 1.0)
            losses.append(float(loss))
    apply_ = jax.jit(jax_ts.make_apply_step(cfg, opt_cfg))
    state = jax_adamw.init_state(trainable, opt_cfg)
    new, _, raw_norm, update_norm = apply_(trainable, accum, state, LR)
    return (losses, float(raw_norm), float(update_norm),
            {k: np.asarray(v) for k, v in new.items()},
            {k: np.asarray(v) for k, v in accum.items()})


def test_split_trainable_matches_jax():
    names = {n: 0 for n in param_shapes(TINY)}
    for kw in (["conv1, conv2"], ["conv1", "conv2"], ["*attn2*"], []):
        jt, jf = jax_ts.split_trainable(names, kw)
        pt, pf = port_ts.split_trainable(names, kw)
        assert (sorted(jt), sorted(jf)) == (sorted(pt), sorted(pf))


def test_micro_and_apply_steps_match_jax(step_inputs, jax_step_run):
    """3 micro steps (GA 3) + 1 apply at fp32 compute. Loss rtol 1e-5;
    raw grad norm rtol 1e-4 (fp32 reductions in another order). Updates
    (new - old params) per tensor: the norm of their difference under 1e-3
    of the update's norm; and where the clipped gradient exceeds 1e-5, each
    element within 1e-3 of lr plus two ulps of the parameter. Adam's first step moves such an element by
    ~3.6 lr whatever its gradient; where the gradient is near eps the step
    is proportional to it instead, and fp32 reduction-order noise on such
    small gradients shows at a few % of lr."""
    np_params, batches, noise, weights = step_inputs
    want_losses, want_norm, want_unorm, want_params, want_accum = jax_step_run
    params = params_from_jax(np_params)
    trainable, frozen = port_ts.split_trainable(params, ["conv1", "conv2"])
    for p in trainable.values():
        p.requires_grad_(True)
    cfg = port_ts.TrainStepConfig(unet=PORT_TINY, prediction_type="v_prediction",
                                  grad_accum_steps=GA, clip_grad_norm=1.0,
                                  attn_impl="xla", compute_dtype=torch.float32)
    opt_cfg = port_adamw.AdamWConfig(debias_strength=0.3,
                                     momentum_dtype=torch.float32)
    micro = port_ts.make_micro_step(cfg)
    apply_ = port_ts.make_apply_step(cfg, opt_cfg)
    state = port_adamw.init_state(trainable, opt_cfg)
    losses = []
    for i, bt in enumerate(batches, start=1):
        bt = {k: torch.from_numpy(v) for k, v in bt.items()}
        loss, _ = micro(trainable, frozen, bt["latents"], bt["embeds"],
                        bt["pooled"], bt["time_ids"], bt["timesteps"],
                        bt["sample_mask"], torch.from_numpy(weights), SEED, i,
                        0.0 if i == 1 else 1.0, noise=torch.from_numpy(noise[i]))
        losses.append(float(loss))
    raw_norm, update_norm = apply_(trainable, state, LR)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert float(raw_norm) == pytest.approx(want_norm, rel=1e-4)
    assert float(update_norm) == pytest.approx(want_unorm, rel=1e-3)
    want_new = params_from_jax(want_params)
    old = params_from_jax(np_params)
    clip = min(1.0, 1.0 / want_norm)
    accum = params_from_jax(want_accum)
    for name, p in trainable.items():
        got_upd = (p.detach() - old[name]).numpy()
        want_upd = (want_new[name] - old[name]).numpy()
        diff = got_upd - want_upd
        assert np.linalg.norm(diff) <= 1e-3 * np.linalg.norm(want_upd), name
        saturated = np.abs(accum[name].numpy() * clip) > 1e-5
        ulps = 2 * np.spacing(np.abs(old[name].numpy()))   # rounding of p
        assert np.all((np.abs(diff) <= 1e-3 * LR + ulps)[saturated]), name
        assert p.grad is None
    assert len(frozen) > 0
