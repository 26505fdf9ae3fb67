"""PyTorch port: bf16 master weights, the GA=1 step (the JAX package's
fused step) and the memory plan in both trainers.

* At GA 1, with fp32 and with bf16 masters, the SDXL and Anima micro step
  accumulates in the masters' dtype and the apply step frees each
  gradient once its tensor is updated, as the JAX fused step does.
* A TINY Anima run with ``MASTER_DTYPE`` bfloat16 at GA 1: the JAX trainer
  and the port's CLI both plan bf16 masters with the fused step and print
  the same plan; their losses agree to 1e-2 relative (the bar of the
  fp32-master runs of ``test_torch_port_anima_trainer``: bf16 compute,
  rounded at different places by XLA's fusions and the eager ops; here
  the masters are bf16 too) and so do their saved DiTs (that file's
  bound: two Adam steps' reach where a rounding flips a tiny gradient,
  plus one bf16 step for the masters' own rounding and one for the save).
* The same run under each forced low-memory rung: the JAX planner's lines
  for that rung (on the run's planner arguments), losses within the JAX
  run's 1e-2; against the int8 run above (the same masters, moments and
  gradients: GA 1 fills ``.grad`` afresh either way) the host-moment run
  repeats the losses and the saved DiT bit for bit, and the two-pass run
  the losses to 1e-6 and the DiT to one bf16 step (its clip factor comes
  from a norm summed in another order).
* The same run under a budget at which the plan keeps bf16 masters but
  downgrades the moments to int8 blockwise (and takes the bf16
  accumulator): it saves the int8 state in the JAX package's format and
  resumes from it with the unbroken run's loss, exactly (the bf16 model
  file holds the bf16 masters as they are, the codes and scales come back
  bit for bit, and the tickets and noise are the step's).
"""

import contextlib
import io
import json
import re
import weakref
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aozora_sdxl_training_tpu.train.reporter as jax_reporter
from aozora_sdxl_training_tpu.config.runtime import RuntimeConfig as JaxConfig
from aozora_sdxl_training_tpu.models.sdxl.arch import TINY
from aozora_sdxl_training_tpu.train import objectives as jax_sdxl_obj
from aozora_sdxl_training_tpu.train.anima_trainer import run_anima_training
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all, read_header
from aozora_sdxl_training_tpu_torch.cli import train_anima as port_cli
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import params_from_jax
from aozora_sdxl_training_tpu_torch.opt import adamw
import aozora_sdxl_training_tpu_torch.train.reporter as port_reporter
from aozora_sdxl_training_tpu_torch.train import anima_trainer as port_anima
from aozora_sdxl_training_tpu_torch.train import memory_policy as port_mp
from aozora_sdxl_training_tpu_torch.train import objectives as port_sdxl_obj
from aozora_sdxl_training_tpu_torch.train import train_step as port_ts

from tests.test_torch_port_anima_dit import numpy_params as dit_numpy_params
from tests.test_torch_port_anima_trainer import CFG as DIT_CFG
from tests.test_torch_port_anima_trainer import LAT, LR, _build_env, _flat, _recording
from tests.test_torch_port_memory_policy import jax_plan_lines, recorded_plans
from tests.test_torch_port_trainer import one_thread
from tests.test_torch_port_unet import numpy_params as unet_numpy_params


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


@pytest.mark.parametrize("master", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", ["sdxl", "anima"])
def test_ga1_step_frees_each_gradient_after_its_update(model, master, monkeypatch):
    """At GA 1 a micro step accumulates in the masters' dtype, and the apply
    step frees each gradient once its tensor is updated (when the update
    reaches tensor i, no more than the gradients of tensors i-1.. are
    alive), leaving no ``.grad`` behind."""
    rng = np.random.default_rng(8)
    opt_cfg = adamw.AdamWConfig(debias_strength=0.3)
    if model == "sdxl":
        params = params_from_jax(unet_numpy_params(TINY, rng))
        cfg = port_ts.TrainStepConfig(unet=TINY, grad_accum_steps=1, clip_grad_norm=0.5,
                                      compute_dtype=torch.bfloat16)
        micro = port_ts.make_micro_step(cfg)
        lat = 8
        batch = (torch.from_numpy(rng.normal(size=(1, lat, lat, 4)).astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(1, 10, TINY.cross_attention_dim))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(1, TINY.pooled_projection_dim))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(1, 6)).astype(np.float32)),
                 torch.tensor([417]), torch.ones(1), torch.ones(1000))
    else:
        params = port_dit.params_from_jax(dit_numpy_params(DIT_CFG, rng))
        cfg = port_anima.AnimaStepConfig(dit=DIT_CFG, grad_accum_steps=1,
                                         clip_grad_norm=0.5, remat="conservative")
        micro = port_anima.make_anima_micro_step(cfg)
        batch = (torch.from_numpy(rng.normal(size=(1, LAT, LAT, DIT_CFG.in_channels))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(1, 12, DIT_CFG.adapter_source_dim))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.integers(1, DIT_CFG.adapter_vocab, (1, 12))),
                 torch.tensor([613]), torch.ones(1), torch.ones(1000))
    apply = port_ts.make_apply_step(cfg, opt_cfg)
    trainable = {k: v.to(master).requires_grad_(True) for k, v in params.items()}
    state = adamw.init_state(trainable, opt_cfg)
    alive_at_update = []
    real_update = adamw.apply_updates

    class Watched(dict):
        def pop(self, name):
            alive_at_update.append(sum(r() is not None for r in refs))
            return super().pop(name)

    def watched_update(params, grads, state, cfg, **kw):
        assert kw.get("release") is True
        watched = Watched(grads)
        grads.clear()       # the caller's dict: ``watched`` holds the only references
        return real_update(params, watched, state, cfg, **kw)

    monkeypatch.setattr(adamw, "apply_updates", watched_update)
    for step in (1, 2):
        before = {k: p.detach().clone() for k, p in trainable.items()}
        loss, _ = micro(trainable, {}, *batch, 7, step, 0.0)
        assert torch.isfinite(loss)
        assert all(p.grad.dtype == master for p in trainable.values())
        refs = [weakref.ref(p.grad) for p in trainable.values()]
        alive_at_update.clear()
        apply(trainable, state, 1e-3 * step)
        n = len(trainable)
        assert alive_at_update[0] == n
        assert all(a <= n - i + 1 for i, a in enumerate(alive_at_update))
        assert all(r() is None for r in refs)
        assert all(p.grad is None and p.dtype == master for p in trainable.values())
        assert any(not torch.equal(before[k], p) for k, p in trainable.items())


# --------------------------------------------------------------------------
# bf16 masters at GA 1 through both trainers
# --------------------------------------------------------------------------

STEPS = 2


@pytest.fixture(scope="module")
def bf16_runs(tmp_path_factory):
    """JAX and port runs, MASTER_DTYPE bfloat16, GA 1, 2 steps; then the
    port under the int8-downgrading budget, saving at step 1, and resumed
    from those files; then the port under each forced low-memory rung
    (``AOZORA_LOWMEM_RUNG``: bf16 masters and int8 moments, as the int8
    run). ``stdout`` also holds, for each port run, the JAX planner's lines
    on that run's planner arguments."""
    root = tmp_path_factory.mktemp("bf16_masters")
    np_params = _build_env(root)
    noise = np.random.default_rng(6).normal(
        size=(STEPS + 1, 1, LAT, LAT, DIT_CFG.in_channels)).astype(np.float32)
    table = jnp.asarray(noise)
    jax_losses, port_losses = [], []
    stdout = {}
    flat = dict(MASTER_DTYPE="bfloat16", GRADIENT_ACCUMULATION_STEPS=1,
                MAX_TRAIN_STEPS=STEPS)
    budget = _int8_budget(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AOZORA_DEVICES", "1")
        mp.setenv("AOZORA_PLATFORM", "cpu")
        mp.delenv("AOZORA_LOWMEM_RUNG", raising=False)
        mp.setattr(jax_sdxl_obj, "noise_for_step", lambda seed, ms, shape: table[ms])
        mp.setattr(port_sdxl_obj, "noise_for_step",
                   lambda seed, ms, shape, device: torch.from_numpy(noise[ms]).to(device))
        mp.setattr(jax_reporter.MetricsReporter, "log_step",
                   _recording(jax_reporter.MetricsReporter, jax_losses))
        mp.setattr(port_reporter.MetricsReporter, "log_step",
                   _recording(port_reporter.MetricsReporter, port_losses))
        with mock.patch("aozora_sdxl_training_tpu.train.anima_trainer."
                        "check_if_anima_caching_needed", return_value=False), \
                mock.patch("aozora_sdxl_training_tpu_torch.train.anima_trainer."
                           "check_if_anima_caching_needed", return_value=False):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                run_anima_training(JaxConfig(_flat(root, "out_jax", **flat),
                                             validate_resume_paths=False))
            stdout["jax"] = out.getvalue()
            state = root / "out_int8" / "anima_run_training_state_step_1.safetensors"
            for name, extra, budget_bytes in (
                    ("port", {}, None),
                    ("int8", {"SAVE_EVERY_N_STEPS": 1}, budget),
                    ("resumed", {"RESUME_TRAINING": True,
                                 "ANIMA_RESUME_MODEL_PATH": str(
                                     root / "out_int8" / "anima_run_step_1.safetensors"),
                                 "ANIMA_RESUME_STATE_PATH": str(state)}, budget),
                    ("two_pass", {}, None), ("moments_host", {}, None)):
                mp.setattr(port_mp, "device_budget_bytes", lambda device, b=budget_bytes: b)
                if name in ("two_pass", "moments_host"):
                    mp.setenv("AOZORA_LOWMEM_RUNG", name)
                preset = root / f"{name}.json"
                preset.write_text(json.dumps(schema.nest_flat_config(
                    _flat(root, f"out_{name}", **flat, **extra), "anima")))
                out = io.StringIO()
                with recorded_plans() as plans, contextlib.redirect_stdout(out):
                    port_cli.main(["--config", str(preset)])
                stdout[name] = out.getvalue()
                # the JAX planner reads AOZORA_LOWMEM_RUNG too: plan while it is set
                stdout[f"{name}_jax_plan"] = jax_plan_lines("anima", plans["anima"][0])
    return root, np_params, jax_losses, port_losses, stdout


def _int8_budget(root) -> int:
    """A budget just under the estimate of bf16 masters with a bf16
    accumulator and bf16 moments: the plan then keeps bf16 masters and
    downgrades the moments to int8 (the fused candidates carry a 0.6 GB
    fragmentation term that no TINY model fits under this budget)."""
    state = port_dit.params_to_torch_state(
        port_dit.params_from_jax(dit_numpy_params(DIT_CFG, np.random.default_rng(0))))
    t = sum(v.numel() for k, v in state.items() if "t_embedder" not in k)
    f = sum(v.numel() for k, v in state.items() if "t_embedder" in k)
    st = port_mp.state_bytes(t, f, master_dtype=torch.bfloat16, frozen_dtype=torch.bfloat16,
                             accum_dtype=torch.bfloat16, moment_dtype=torch.bfloat16)
    tokens = (LAT // DIT_CFG.patch_spatial) ** 2
    act = int(port_mp._ANIMA_ACT_BYTES_PER_TOKEN[True] * tokens)
    return st["peak_state"] + act + port_mp._RESERVE_BYTES - 1


def _plan_lines(out: str) -> list[str]:
    """``describe_plan``'s lines in a trainer's output."""
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("INFO: Memory plan"))
    end = start + 1
    while end < len(lines) and lines[end].startswith("INFO:   "):
        end += 1
    return lines[start:end]


def test_bf16_master_ga1_run_matches_jax_trainer(bf16_runs):
    root, np_params, jax_losses, port_losses, stdout = bf16_runs
    for name in ("jax", "port"):
        assert "master weights: bfloat16" in stdout[name]
        assert "fused into the train step (GA=1, no accum tree)" in stdout[name]
    assert _plan_lines(stdout["port"]) == _plan_lines(stdout["jax"])
    assert len(jax_losses) == STEPS and all(np.isfinite(port_losses))
    rel = np.abs(np.subtract(port_losses[:STEPS], jax_losses)) / np.abs(jax_losses)
    print(f"bf16 masters, GA 1: losses {port_losses[:STEPS]} against {jax_losses} "
          f"(largest relative difference {rel.max():.3e})")
    np.testing.assert_allclose(port_losses[:STEPS], jax_losses, rtol=1e-2)
    port = load_all(root / "out_port" / "anima_run.safetensors")
    ref = load_all(root / "out_jax" / "anima_run.safetensors")
    assert port.keys() == ref.keys()
    for key in ref:
        a, b = (np.asarray(x[key], np.float32) for x in (port, ref))
        if ".t_embedder." in key:
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        np.testing.assert_allclose(a, b, rtol=2 * 2.0 ** -7,
                                   atol=2 * (3.63 + 4.71) * LR * 1.01, err_msg=key)


def test_downgraded_int8_moments_resume_with_bf16_masters(bf16_runs):
    root, _, _, port_losses, stdout = bf16_runs
    out = stdout["int8"]
    assert "master weights: bfloat16" in out and "moments: int8_blockwise" in out
    assert "bfloat16 accum tree" in out
    assert "WARNING: moment storage downgraded to int8_blockwise" in out
    header = read_header(root / "out_int8" / "anima_run_training_state_step_1.safetensors")
    assert any(k.endswith("@scales") for k in header)
    assert {v["dtype"] for k, v in header.items() if k.startswith("m.")
            and not k.endswith("@scales")} <= {"I8", "F32"}
    resumed = stdout["resumed"]
    assert "INFO: Restored optimizer state from resume checkpoint." in resumed
    assert [int(m) for m in re.findall(r"--- Optimizer Step: (\d+)", resumed)] == [2]
    # losses: port run 2, int8 run 2, resumed run 1 (its step 2), then the
    # two forced-rung runs 2 each
    assert len(port_losses) == 4 * STEPS + 1
    print(f"resumed step 2's loss {port_losses[2 * STEPS]!r} against "
          f"{port_losses[2 * STEPS - 1]!r}")
    assert port_losses[2 * STEPS] == port_losses[2 * STEPS - 1]


@pytest.mark.parametrize("rung", ["two_pass", "moments_host"])
def test_forced_rung_runs_match_the_int8_run_and_jax(bf16_runs, rung):
    root, _, jax_losses, port_losses, stdout = bf16_runs
    out = stdout[rung]
    assert _plan_lines(out) == stdout[f"{rung}_jax_plan"]
    assert ("two-pass step" in out) == (rung == "two_pass")
    assert ("OFFLOADED to pinned host memory" in out) == (rung == "moments_host")
    # losses: port 2, int8 2, resumed 1, two_pass 2, moments_host 2
    start = 2 * STEPS + 1 + (0 if rung == "two_pass" else STEPS)
    got, int8 = port_losses[start:start + STEPS], port_losses[STEPS:2 * STEPS]
    print(f"{rung}: losses {got} against the int8 run's {int8} and JAX's {jax_losses}")
    np.testing.assert_allclose(got, jax_losses, rtol=1e-2)
    if rung == "moments_host":
        assert got == int8
    else:
        np.testing.assert_allclose(got, int8, rtol=1e-6)
    mine = load_all(root / f"out_{rung}" / "anima_run.safetensors")
    ref = load_all(root / "out_int8" / "anima_run.safetensors")
    assert mine.keys() == ref.keys()
    for key in ref:
        a, b = (np.asarray(x[key], np.float32) for x in (mine, ref))
        if rung == "moments_host":
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0, err_msg=key)
