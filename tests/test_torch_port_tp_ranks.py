"""PyTorch port: both CLIs on two gloo ranks at ``TENSOR_PARALLEL_SIZE`` 2
against one process and against the JAX trainers at tp 2.

SDXL: one checkpoint and cache (``tests/test_torch_port_trainer.
_build_env``) of ``UNET``, a two-level TINY whose 32-wide level has one
head, which tp 2 does not divide (its layers gather q/k/v and run the head
whole), and whose 64-wide level and mid block have two (one a rank); one
noise table for every run, fp32 compute, ``paged_adamw_8bit`` with int8
moments from ``MIN_8BIT`` elements (column slices, GEGLU halves and row
slices among them: their blocks straddle the tp slices), GA 1, 2 optimizer
steps, a save at each. The runs:

* ``tp2``: the port's CLI on 2 ranks (dp 1 x tp 2);
* ``one``: the port's CLI in one process;
* the JAX trainer on 2 virtual CPU devices with ``TENSOR_PARALLEL_SIZE`` 2
  (its ("dp", "tp") mesh), in this process while the ranks run, up to
  optimizer step 1 and its save;
* then each port run resumed from its optimizer-step-1 files on the other
  layout (``tp2_to_one``, ``one_to_tp2``), each writing the optimizer state
  it restored back out through ``save_train_state``.

Anima: the TINY DiT and cache of ``tests/test_torch_port_anima_trainer``
(8 x 8 latents, the LLM adapter trainable), one noise table for every run,
Conservative remat, fp32, GA 2, 4 micro steps, at tp 2 on 2 ranks and in
one process, and the JAX trainer on 2 virtual CPU devices with
``TENSOR_PARALLEL_SIZE`` 2 (after the JAX SDXL run, in this process). Only
the Anima tp path sums the per-head q/k norm scales' partial gradients
over tp, copies the adapter's context into the blocks once, and keeps
Conservative's "mlp_down" after its reduce.

Bars: those of ``tests/test_torch_port_sdxl_dp.py`` (losses within 2e-5;
the saved models by ``_same_training``). The restored moments equal the
file's bit for bit.
"""

import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

import aozora_sdxl_training_tpu.train.reporter as jax_reporter
from aozora_sdxl_training_tpu.config import schema as jax_schema
from aozora_sdxl_training_tpu.config.runtime import RuntimeConfig as JaxConfig
from aozora_sdxl_training_tpu.models.sdxl.arch import TINY
from aozora_sdxl_training_tpu.parallel import sharding as jax_sharding
from aozora_sdxl_training_tpu.train import objectives as jax_obj
from aozora_sdxl_training_tpu.train import sampler as jax_sampler
from aozora_sdxl_training_tpu.train import trainer as jax_trainer
from aozora_sdxl_training_tpu.train.anima_trainer import run_anima_training
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all
from aozora_sdxl_training_tpu_torch.config import schema

from tests.test_torch_port_anima_trainer import (
    CFG as ANIMA_CFG, FLAT as ANIMA_FLAT, LAT as ANIMA_LAT, _build_env as _build_anima_env,
    _flat as _anima_flat, _recording)
from tests.test_torch_port_ranks import finish, run_task, start, world_env
from tests.test_torch_port_sdxl_dp import _losses, _same_training, _state, _unet
from tests.test_torch_port_trainer import FLAT, _build_env

UNET = replace(TINY, block_out_channels=(32, 64), transformer_layers=(1, 1),
               num_heads=(1, 2), mid_transformer_layers=1)
STEPS, MIN_8BIT = 2, 4096
TP_FLAT = {**FLAT, "MAX_TRAIN_STEPS": STEPS, "GRADIENT_ACCUMULATION_STEPS": 1,
           "SAVE_EVERY_N_STEPS": 1, "OPTIMIZER_TYPE": "paged_adamw_8bit",
           "PAGED_ADAMW_8BIT_PARAMS": {"betas": [0.9, 0.999], "eps": 1e-8,
                                       "weight_decay": 0.01, "min_8bit_size": MIN_8BIT}}
# name: (ranks, the run whose step-1 files it resumes, or None)
RUNS = {"tp2": (2, None), "one": (1, None), "tp2_to_one": (1, "tp2"),
        "one_to_tp2": (2, "one")}
ANIMA_RUNS = {"anima_tp2": 2, "anima_one": 1}
TP_LINE = re.compile(r"INFO: Tensor parallelism over tp=2 \(gloo, dp=1\)")
HELD = re.compile(r"INFO: Tensor parallel held per rank: split elements \[(\d+), (\d+)\] "
                  r"of ([\d,]+)")
TRAFFIC = re.compile(r"INFO: Tensor parallel collectives a micro step on this rank: "
                     r"([\d,]+) bytes \(([^)]*)\)")


def _flat(root: Path, name: str) -> dict:
    ranks, source = RUNS[name]
    flat = {**TP_FLAT, "TENSOR_PARALLEL_SIZE": ranks, "OUTPUT_DIR": str(root / name),
            "SINGLE_FILE_CHECKPOINT_PATH": str(root / "base.safetensors"),
            "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}]}
    if source:
        flat.update(RESUME_TRAINING=True,
                    RESUME_MODEL_PATH=str(root / source / "run_step_1.safetensors"),
                    RESUME_STATE_PATH=str(root / source / "run_training_state_step_1.safetensors"))
    return flat


def _start_sdxl(root: Path, names) -> list:
    started = []
    for name in names:
        preset = root / f"{name}.json"
        preset.write_text(json.dumps(schema.nest_flat_config(_flat(root, name), "sdxl")))
        (root / name).mkdir()
        cmd = [sys.executable, "-m", "tests.test_torch_port_ranks", "sdxl_cli",
               str(root / "noise.npy"), str(preset), str(root / name / "restored.safetensors")]
        ranks = RUNS[name][0]
        envs = world_env(ranks, root / f"{name}_store") if ranks > 1 else [{}]
        started += [(name, p) for p in start([cmd] * len(envs), root / name, env=envs)]
    return started


def _anima_run_flat(root: Path, name: str, tp: int) -> dict:
    return _anima_flat(root, name, TENSOR_PARALLEL_SIZE=tp,
                       ANIMA_GRADIENT_CHECKPOINTING_MODE="Conservative")


def _start_anima(root: Path) -> list:
    """The Anima runs (fp32, FSDP's threshold left at the JAX package's
    2^16: at dp 1 nothing shards), in the directory the cache was
    written from."""
    started = []
    for name, ranks in ANIMA_RUNS.items():
        preset = root / f"{name}.json"
        preset.write_text(json.dumps(schema.nest_flat_config(
            _anima_run_flat(root, name, ranks), "anima")))
        cmd = [sys.executable, "-m", "tests.test_torch_port_ranks", "anima_cli", "65536",
               str(preset), "fp32,nocache", str(root / "noise.npy")]
        envs = world_env(ranks, root / f"{name}_store") if ranks > 1 else [{}]
        started += [(name, p) for p in start([cmd] * len(envs), root, env=envs)]
    return started


def _finish(started) -> dict:
    results = finish([p for _, p in started], timeout=300)
    out: dict = {}
    for (name, _), (code, stdout, stderr) in zip(started, results):
        assert code == 0, f"{name} rank {len(out.get(name, []))} exited {code}:\n{stdout}\n{stderr}"
        out.setdefault(name, []).append(stdout)
    return out


class _StepOneDone(Exception):
    """Ends the JAX run after optimizer step 1 and its save."""


def _jax_anima(root: Path, noise: np.ndarray) -> tuple:
    """The JAX Anima trainer on 2 virtual CPU devices at tp 2 (fp32):
    returns its per-micro-step losses and the mesh layout it resolved."""
    table = jnp.asarray(noise)
    losses, layouts = [], []
    resolve = jax_sharding.resolve_mesh_layout

    def kept_layout(config):
        layouts.append(resolve(config))
        return layouts[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AOZORA_DEVICES", "2")
        mp.setattr(jax_obj, "noise_for_step", lambda seed, ms, shape: table[ms])
        mp.setattr(jax_reporter.MetricsReporter, "log_step",
                   _recording(jax_reporter.MetricsReporter, losses))
        mp.setattr(jax_sharding, "resolve_mesh_layout", kept_layout)
        with mock.patch("aozora_sdxl_training_tpu.train.anima_trainer."
                        "check_if_anima_caching_needed", return_value=False):
            config = JaxConfig(_anima_run_flat(root, "jax_anima_tp2", 2),
                               validate_resume_paths=False)
            config.compute_dtype = jnp.float32
            run_anima_training(config)
    return losses, layouts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Returns (root, {run: [stdout of each rank]}, the JAX runs: the SDXL
    step-1 loss, the Anima losses and mesh layouts): the SDXL runs, then
    their resumes, and the Anima runs, all in subprocesses beside the JAX
    runs."""
    root = tmp_path_factory.mktemp("port_tp")
    _build_env(root, UNET)
    noise = np.random.default_rng(8).normal(size=(STEPS + 1, 1, 8, 8, 4))
    np.save(root / "noise.npy", noise.astype(np.float32))
    anima_root = root / "anima"
    anima_root.mkdir()
    _build_anima_env(anima_root)
    anima_noise = np.random.default_rng(9).normal(size=(
        int(ANIMA_FLAT["MAX_TRAIN_STEPS"]) + 1, 1, ANIMA_LAT, ANIMA_LAT,
        ANIMA_CFG.in_channels)).astype(np.float32)
    np.save(anima_root / "noise.npy", anima_noise)

    def ports():
        first = _start_sdxl(root, ["tp2", "one"]) + _start_anima(anima_root)
        out = _finish(first)
        return {**out, **_finish(_start_sdxl(root, ["tp2_to_one", "one_to_tp2"]))}

    ranks = ThreadPoolExecutor(1).submit(ports)
    table = jnp.asarray(noise.astype(np.float32))
    jax_losses: list = []
    micro_and_apply = jax_trainer.jit_train_functions

    def kept_losses(*args, **kwargs):
        micro, apply = micro_and_apply(*args, **kwargs)

        def micro_kept(*step_args):
            out = micro(*step_args)
            jax_losses.append(float(out[0]))
            return out
        return micro_kept, apply

    def step_one_done(self, optimizer_step, *args, **kwargs):
        raise _StepOneDone

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("AOZORA_DEVICES", "2")
            mp.setattr(jax_obj, "noise_for_step", lambda seed, ms, shape: table[ms])
            mp.setattr(jax_trainer, "jit_train_functions", kept_losses)
            mp.setattr(jax_sampler.PreviewRenderer, "maybe_render", step_one_done)
            with mock.patch("aozora_sdxl_training_tpu.train.trainer."
                            "check_if_caching_needed", return_value=False):
                config = JaxConfig(jax_schema.flatten_preset(schema.nest_flat_config(
                    {**_flat(root, "tp2"), "OUTPUT_DIR": str(root / "jax_tp2")}, "sdxl")),
                    validate_resume_paths=False)
                config.compute_dtype = jnp.float32
                with pytest.raises(_StepOneDone):
                    jax_trainer.run_sdxl_training(config, unet_cfg=UNET)
        anima_losses, anima_layouts = _jax_anima(anima_root, anima_noise)
    finally:
        out = ranks.result()
    return root, out, {"sdxl": jax_losses, "anima": anima_losses,
                       "anima_layouts": anima_layouts}


def _held(stdout: str) -> tuple:
    m = HELD.search(stdout)
    assert m, "no tp held line"
    return int(m.group(1)), int(m.group(2)), int(m.group(3).replace(",", ""))


def test_tp_run_matches_one_process(runs):
    """Losses and the saved UNet after 2 steps; the tp line says what is
    split, each rank holds half of it, and both the head-cut layers'
    gathers and the local heads' reduces ran."""
    root, out, _ = runs
    got, want = _losses(out["tp2"][0]), _losses(out["one"][0])
    assert len(got) == len(want) == STEPS and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    _same_training(_unet(root / "tp2" / "run.safetensors"),
                   _unet(root / "one" / "run.safetensors"),
                   _unet(root / "base.safetensors"), STEPS)
    assert TP_LINE.search(out["tp2"][0]) and not TP_LINE.search(out["one"][0])
    a, b, total = _held(out["tp2"][0])
    assert a == b == total // 2 and total > 0
    traffic = dict(kv.split(" ") for kv in TRAFFIC.search(out["tp2"][0]).group(2).split(", "))
    assert set(traffic) == {"copy", "gather", "reduce", "scatter"}
    assert out["tp2"][1].strip() == ""


def test_tp_run_matches_jax_trainer_on_two_devices(runs):
    """Optimizer step 1 against the JAX trainer's ("dp", "tp") mesh: its
    loss and the model saved after it."""
    root, out, jax = runs
    jax_losses = jax["sdxl"]
    assert len(jax_losses) == 1
    np.testing.assert_allclose(_losses(out["tp2"][0])[:1], jax_losses, rtol=0, atol=2e-5)
    _same_training(_unet(root / "tp2" / "run_step_1.safetensors"),
                   _unet(root / "jax_tp2" / "run_step_1.safetensors"),
                   _unet(root / "base.safetensors"), 1)


def test_tp_state_file_is_the_one_process_layout(runs):
    """The state saved at tp 2 holds what one process's holds: the same
    keys, shapes and dtypes (int8 codes of tp-split tensors among them,
    with the whole tensor's scales), and the moments within float noise."""
    root, _, _ = runs
    got = _state(root / "tp2" / "run_training_state_step_1.safetensors")
    want = _state(root / "one" / "run_training_state_step_1.safetensors")
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == value.dtype, key
    split_int8 = [k for k in want if k.endswith("@scales") and
                  any(s in k for s in (".ff.net.0.proj.", ".ff.net.2.", ".to_q.", ".to_out.0."))]
    assert len(split_int8) >= 4
    for key in split_int8:
        codes = key[:-len("@scales")]
        assert np.abs(got[codes].astype(np.int32) - want[codes]).max() <= 1, codes
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("name", ["tp2_to_one", "one_to_tp2"])
def test_training_state_resumes_across_tp(runs, name):
    """The state of optimizer step 1 saved on one layout resumes on the
    other: the moments the trainer restored are the file's bit for bit
    (gathered from the tp slices where they are held so), and the resumed
    step's loss is the unbroken run's."""
    root, out, _ = runs
    source = RUNS[name][1]
    saved = _state(root / source / "run_training_state_step_1.safetensors")
    restored = _state(root / name / "restored.safetensors")
    assert saved.keys() == restored.keys()
    for key, value in saved.items():
        assert value.dtype == restored[key].dtype and np.array_equal(value, restored[key]), key
    assert "INFO: Restored optimizer state from resume checkpoint." in out[name][0]
    resumed, unbroken = _losses(out[name][0]), _losses(out[source][0])
    assert len(resumed) == 1
    np.testing.assert_allclose(resumed, unbroken[1:], rtol=0, atol=2e-5)


def _same_dit(root: Path, got: str, want: str) -> None:
    """Two saved DiTs after the Anima runs' optimizer steps: within one
    bf16 rounding and Adam's largest step a step of each other, and the
    same update from the base (norm within 1%, cosine >= 0.99)."""
    got_dit, want_dit, base = (load_all(root / "anima" / path) for path in (
        f"{got}/anima_run.safetensors", f"{want}/anima_run.safetensors",
        "tiny_dit.safetensors"))
    assert got_dit.keys() == want_dit.keys()
    lr, optim_steps = ANIMA_FLAT["LR_CUSTOM_CURVE"][0][1], int(
        ANIMA_FLAT["MAX_TRAIN_STEPS"]) // ANIMA_FLAT["GRADIENT_ACCUMULATION_STEPS"]
    upd_got, upd_want = [], []
    for key in want_dit:
        a, b = (np.asarray(t[key], np.float32) for t in (got_dit, want_dit))
        w0 = np.asarray(base[f"pipe.dit.{key}" if f"pipe.dit.{key}" in base else key],
                        np.float32)
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=2 * optim_steps * lr * 1.01,
                                   err_msg=key)
        upd_got.append((a - w0).ravel())
        upd_want.append((b - w0).ravel())
    upd_got, upd_want = np.concatenate(upd_got), np.concatenate(upd_want)
    n_got, n_want = np.linalg.norm(upd_got), np.linalg.norm(upd_want)
    assert n_want > 0 and n_got == pytest.approx(n_want, rel=1e-2)
    assert upd_got @ upd_want / (n_got * n_want) >= 0.99


def test_anima_tp_run_matches_one_process(runs):
    """The Anima CLI at tp 2 (Conservative, the adapter trainable): the
    per-step losses and the saved DiT of one process."""
    root, out, _ = runs
    steps = int(ANIMA_FLAT["MAX_TRAIN_STEPS"])
    pattern = re.compile(r"Loss:\s*([\d.e+-]+)")
    got = [float(x) for x in pattern.findall(out["anima_tp2"][0])]
    want = [float(x) for x in pattern.findall(out["anima_one"][0])]
    assert len(got) == len(want) >= steps and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert TP_LINE.search(out["anima_tp2"][0])
    a, b, total = _held(out["anima_tp2"][0])
    assert a == b == total // 2 and total > 0
    _same_dit(root, "anima_tp2", "anima_one")


def test_anima_tp_run_matches_jax_trainer_on_two_devices(runs):
    """The Anima CLI at tp 2 against the JAX trainer's ("dp", "tp") mesh of
    2 devices (dp 1 x tp 2): each optimizer step's loss (the mean of its
    micro steps') and the saved DiT, with the bars above."""
    root, out, jax = runs
    (layout,) = jax["anima_layouts"]
    assert (layout.dp, layout.tp, layout.use_mesh) == (1, 2, True)
    ga = ANIMA_FLAT["GRADIENT_ACCUMULATION_STEPS"]
    jax_losses = np.asarray(jax["anima"])
    assert len(jax_losses) == int(ANIMA_FLAT["MAX_TRAIN_STEPS"])
    got = _losses(out["anima_tp2"][0])
    np.testing.assert_allclose(got, jax_losses.reshape(-1, ga).mean(1), rtol=0, atol=2e-5)
    _same_dit(root, "anima_tp2", "jax_anima_tp2")


def test_make_mesh_tp_groups_on_four_ranks(tmp_path):
    """dp=2 x tp=2: rank = dp_index * tp + tp_index. Each rank all-reduces
    its global rank within its dp group and within its tp group."""
    np.savez(tmp_path / "inputs.npz", dp=2, tp=2)
    ranks = run_task("mesh", 4, tmp_path / "inputs.npz", tmp_path, timeout=120)
    for r, got in enumerate(ranks):
        dp_rank, tp_rank = divmod(r, 2)
        assert (int(got["dp_rank"]), int(got["tp_rank"])) == (dp_rank, tp_rank)
        assert int(got["dp_sum"]) == tp_rank + (2 + tp_rank)
        assert int(got["tp_sum"]) == 2 * dp_rank + (2 * dp_rank + 1)
