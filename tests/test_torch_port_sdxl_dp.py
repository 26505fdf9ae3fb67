"""PyTorch port: the SDXL CLI on two gloo ranks (dp 2, FSDP) against one
process and against the JAX trainer on two devices.

One TINY checkpoint and cache (``tests/test_torch_port_trainer._build_env``:
4 latents of 8 x 8, the conv1/conv2 weights frozen), one noise table for
every run, computing in fp32 (each CLI's parsed config gets
``compute_dtype`` float32: the presets' ``MIXED_PRECISION`` has no fp32
value; the models are saved in it too), ``paged_adamw_8bit`` with int8
moments for tensors of 131,072 elements or more (so both fp32 and int8
moments are sharded: FSDP shards from 65,536), GA 1, 2 optimizer steps,
a save at each. The runs:

* ``dp2``: the port's CLI on 2 ranks (``tests/test_torch_port_ranks.py``,
  each a fresh interpreter), ``BATCH_SIZE`` 1 per rank;
* ``one_b2``: the port's CLI in one process at ``BATCH_SIZE`` 2;
* the JAX trainer on 2 virtual CPU devices (``AOZORA_DEVICES=2``, its FSDP
  mesh) at ``BATCH_SIZE`` 1, in this process while the ranks run, up to
  optimizer step 1 and its save;
* then (still beside the JAX run) each port run resumed from its
  optimizer-step-1 files on the other
  world size (``dp2_to_one``: 1 process at ``BATCH_SIZE`` 2;
  ``one_to_dp2``: 2 ranks), each writing the optimizer state it restored
  back out through ``save_train_state``.

Tolerances: in fp32 the runs differ by the order of their sums (the
ranks' reduce-scatter, XLA's fusions); the losses (printed to 5 decimals)
agree to 2e-5; the saved UNets lie within the JAX end-to-end test's bar
(max relative difference < 0.05) and each weight within 2 lr a step of
the other run's (Adam moves a weight by at most lr a step, so a float
noise that flips a tiny gradient's sign costs at most 2 lr), with the
same update (norm to 1e-3, cosine 0.999). The restored moments equal the
file's bit for bit.
"""

import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

from aozora_sdxl_training_tpu.config import schema as jax_schema
from aozora_sdxl_training_tpu.config.runtime import RuntimeConfig as JaxConfig
from aozora_sdxl_training_tpu.models.sdxl.arch import TINY
from aozora_sdxl_training_tpu.train import objectives as jax_obj
from aozora_sdxl_training_tpu.train import sampler as jax_sampler
from aozora_sdxl_training_tpu.train import trainer as jax_trainer
from aozora_sdxl_training_tpu.train.trainer import run_sdxl_training
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all, read_header
from aozora_sdxl_training_tpu_torch.config import schema

from tests.test_torch_port_ranks import finish, start, world_env
from tests.test_torch_port_trainer import FLAT, LAT, LR, _build_env

STEPS, MIN_8BIT = 2, 131072
DP_FLAT = {**FLAT, "MAX_TRAIN_STEPS": STEPS, "GRADIENT_ACCUMULATION_STEPS": 1,
           "SAVE_EVERY_N_STEPS": 1,
           "OPTIMIZER_TYPE": "paged_adamw_8bit",
           "PAGED_ADAMW_8BIT_PARAMS": {"betas": [0.9, 0.999], "eps": 1e-8,
                                       "weight_decay": 0.01, "min_8bit_size": MIN_8BIT}}
# at GA 1 each micro step's loss, to 5 decimals, in its optimizer block
OPTIM_STEP = re.compile(r'--- Optimizer Step:\s*(\d+)\s*\|\s*Loss:\s*([\d.e+-]+)')
# name: (ranks, BATCH_SIZE, the run whose step-1 files it resumes, or None)
RUNS = {"dp2": (2, 1, None), "one_b2": (1, 2, None),
        "dp2_to_one": (1, 2, "dp2"), "one_to_dp2": (2, 1, "one_b2")}
# the run that saves on the GUI's force-save flag (dropped in its working
# directory before it starts) instead of on a schedule
FORCED = "one_to_dp2"


def _flat(root: Path, name: str) -> dict:
    ranks, batch, source = RUNS[name]
    flat = {**DP_FLAT, "BATCH_SIZE": batch, "OUTPUT_DIR": str(root / name),
            "SINGLE_FILE_CHECKPOINT_PATH": str(root / "base.safetensors"),
            "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}]}
    if name == FORCED:
        flat["SAVE_EVERY_N_STEPS"] = 0
    if source:
        flat.update(RESUME_TRAINING=True,
                    RESUME_MODEL_PATH=str(root / source / "run_step_1.safetensors"),
                    RESUME_STATE_PATH=str(root / source / "run_training_state_step_1.safetensors"))
    return flat


def _start(root: Path, names) -> list:
    """Starts each named run's processes, in its output directory; returns
    [(name, process)]."""
    started = []
    for name in names:
        preset = root / f"{name}.json"
        preset.write_text(json.dumps(schema.nest_flat_config(_flat(root, name), "sdxl")))
        (root / name).mkdir()
        if name == FORCED:
            (root / name / "force_save.flag").write_text("")
        cmd = [sys.executable, "-m", "tests.test_torch_port_ranks", "sdxl_cli",
               str(root / "noise.npy"), str(preset), str(root / name / "restored.safetensors")]
        ranks = RUNS[name][0]
        envs = world_env(ranks, root / f"{name}_store") if ranks > 1 else [{}]
        started += [(name, proc) for proc in start([cmd] * len(envs), root / name, env=envs)]
    return started


def _finish(started) -> dict:
    results = finish([p for _, p in started], timeout=300)
    out: dict = {}
    for (name, _), (code, stdout, stderr) in zip(started, results):
        assert code == 0, f"{name} rank {len(out.get(name, []))} exited {code}:\n{stdout}\n{stderr}"
        out.setdefault(name, []).append(stdout)
    return out


class _StepOneDone(Exception):
    """Ends the JAX run after optimizer step 1 and its save: its second
    step would compile the micro step again (the sharded parameters come
    back from the first apply step in other shardings) for no new check."""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Returns (root, {run: [stdout of each rank]}, the JAX run's step-1
    loss)."""
    root = tmp_path_factory.mktemp("port_sdxl_dp")
    _build_env(root)
    noise = np.random.default_rng(8).normal(size=(STEPS + 1, 2, LAT, LAT, 4))
    np.save(root / "noise.npy", noise.astype(np.float32))
    # the port's runs, then their resumes, go on beside the JAX run
    ranks = ThreadPoolExecutor(1).submit(
        lambda: {**_finish(_start(root, ["dp2", "one_b2"])),
                 **_finish(_start(root, ["dp2_to_one", "one_to_dp2"]))})
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
                # from the nested preset, as the port's CLI reads it; the
                # schedules are those of MAX_TRAIN_STEPS 2
                config = JaxConfig(jax_schema.flatten_preset(schema.nest_flat_config(
                    {**_flat(root, "one_b2"), "BATCH_SIZE": 1,
                     "OUTPUT_DIR": str(root / "jax_dp2")}, "sdxl")),
                    validate_resume_paths=False)
                config.compute_dtype = jnp.float32
                with pytest.raises(_StepOneDone):
                    run_sdxl_training(config, unet_cfg=TINY)
    finally:
        out = ranks.result()
    return root, out, jax_losses


def _losses(stdout: str) -> list:
    by_step = {int(m.group(1)): float(m.group(2)) for m in OPTIM_STEP.finditer(stdout)}
    return [by_step[s] for s in sorted(by_step)]


def _max_rel_diff(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    diffs = []
    for key, b in want.items():
        a32, b32 = np.asarray(got[key], np.float32), np.asarray(b, np.float32)
        diffs.append(float((np.abs(a32 - b32) / np.maximum(np.abs(b32), 1e-3)).max()))
    return max(diffs)


def _unet(path: Path) -> dict:
    return {k: v for k, v in load_all(path).items() if k.startswith("model.diffusion_model.")}


def _same_training(got: dict, want: dict, base: dict, steps: int) -> None:
    """Two runs' saved UNets after ``steps`` optimizer steps from ``base``:
    within the JAX end-to-end test's bar (max relative difference < 0.05),
    each weight within Adam's largest step apart per step (a float noise
    that flips a tiny gradient's sign moves a weight by up to 2 lr), and
    the whole update the same (norm within 1e-3, cosine >= 0.999)."""
    assert _max_rel_diff(got, want) < 0.05
    upd_got, upd_want = [], []
    for key in want:
        a, b, w0 = (np.asarray(t[key], np.float32) for t in (got, want, base))
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * steps * LR * 1.01, err_msg=key)
        upd_got.append((a - w0).ravel())
        upd_want.append((b - w0).ravel())
    upd_got, upd_want = np.concatenate(upd_got), np.concatenate(upd_want)
    n_got, n_want = np.linalg.norm(upd_got), np.linalg.norm(upd_want)
    assert n_want > 0 and n_got == pytest.approx(n_want, rel=1e-3)
    assert upd_got @ upd_want / (n_got * n_want) >= 0.999


def test_dp_run_matches_one_process_at_the_global_batch(runs):
    root, out, _ = runs
    got, want = _losses(out["dp2"][0]), _losses(out["one_b2"][0])
    assert len(got) == len(want) == STEPS and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    _same_training(_unet(root / "dp2" / "run.safetensors"),
                   _unet(root / "one_b2" / "run.safetensors"),
                   _unet(root / "base.safetensors"), STEPS)
    assert "INFO: FSDP over dp=2 (gloo)" in out["dp2"][0]
    assert "sharded over 2 device(s) (ZeRO)" in out["dp2"][0]


def test_dp_run_matches_jax_trainer_on_two_devices(runs):
    """Optimizer step 1: its loss and the model saved after it."""
    root, out, jax_losses = runs
    got = _losses(out["dp2"][0])
    assert len(jax_losses) == 1
    np.testing.assert_allclose(got[:1], jax_losses, rtol=0, atol=2e-5)
    _same_training(_unet(root / "dp2" / "run_step_1.safetensors"),
                   _unet(root / "jax_dp2" / "run_step_1.safetensors"),
                   _unet(root / "base.safetensors"), 1)


def test_only_rank_0_prints_and_writes(runs):
    """Rank 1 prints nothing; the output directory holds what one process
    writes (the step files, the final model; the header of a merged file
    as one process writes it)."""
    root, out, _ = runs
    for name in ("dp2", "one_to_dp2"):
        assert out[name][1].strip() == ""
        assert "All tasks complete" in out[name][0]
    want = sorted([f"run{kind}_step_{n}.safetensors"
                   for kind in ("", "_training_state") for n in (1, 2)] + ["run.safetensors"])
    assert sorted(p.name for p in (root / "dp2").glob("*.safetensors")) == want
    assert read_header(root / "dp2" / "run.safetensors") == read_header(
        root / "one_b2" / "run.safetensors")


def _state(path: Path) -> dict:
    return {k: np.asarray(v) for k, v in load_all(path).items()}


@pytest.mark.parametrize("name", ["dp2_to_one", "one_to_dp2"])
def test_training_state_resumes_across_world_sizes(runs, name):
    """The state of optimizer step 1 saved on one world size resumes on
    the other: the moments the trainer restored are the file's bit for bit
    (fp32 moments, int8 codes and their scales; sharded tensors among
    both), and the resumed step's loss is the unbroken run's."""
    root, out, _ = runs
    source = RUNS[name][2]
    saved = _state(root / source / "run_training_state_step_1.safetensors")
    restored = _state(root / name / "restored.safetensors")
    assert saved.keys() == restored.keys()
    for key, value in saved.items():
        assert value.dtype == restored[key].dtype and np.array_equal(value, restored[key]), key
    int8 = [k for k in saved if k.endswith("@scales")]
    fp32_big = [k for k, v in saved.items() if v.dtype == np.float32
                and v.size >= 2 ** 16 and not k.endswith("@scales")]
    assert int8 and fp32_big                 # both kinds, sharded (>= 2^16 elements)
    assert "INFO: Restored optimizer state from resume checkpoint." in out[name][0]
    resumed, unbroken = _losses(out[name][0]), _losses(out[source][0])
    assert len(resumed) == 1
    np.testing.assert_allclose(resumed, unbroken[1:], rtol=0, atol=2e-5)


def test_force_save_flag_saves_on_every_rank(runs):
    """The GUI's force-save flag, read by global rank 0 alone, makes the
    2-rank resumed run (no scheduled saves) gather and save at its next
    optimizer step on every rank (rank 0's word broadcast first: no rank
    waits in a gather alone), and the flag is consumed."""
    root, out, _ = runs
    assert "Emergency checkpoint requested at optimizer step 2" in out[FORCED][0]
    assert not (root / FORCED / "force_save.flag").exists()
    saved = _state(root / FORCED / "run_training_state_step_2.safetensors")
    assert int(saved["opt.step"]) == 2 and (root / FORCED / "run_step_2.safetensors").exists()
