"""PyTorch port: the Anima CLI under pipeline parallelism and video mode under
sequence parallelism, on gloo ranks of the CPU.

Every run is the port's Anima CLI in fresh interpreters without JAX
(``tests/test_torch_port_ranks.py``'s ``anima_cli``), computing in fp32
(the presets' ``MIXED_PRECISION`` has no fp32 value), on a random TINY DiT
of 4 blocks (one head) over a synthetic cache of two 64 x 64 images (the
640 bucket: 1,600 tokens),
``BATCH_SIZE`` 2, GA 1 (each step's loss to 5 decimals in its optimizer
block), 2 micro steps, saving at each optimizer step:

* ``pp2``: two ranks, ``PIPELINE_PARALLEL_SIZE`` 2,
  ``ANIMA_PIPELINE_MICROBATCHES`` 2, against ``one``, one process: losses
  to 2e-5, the saved DiTs (flat reference names) within two updates of
  each other with cosine >= 0.999 between the two runs' updates; only
  rank 0 prints and writes (its latent-RGB previews too, after every
  rank gathered the stages); the training-state file has the JAX
  package's ``stackify_params`` keys and shapes of the one-process file's
  and JAX's loader reads it.
* Resume: ``one`` -> pp 2 restacks the state (JAX's INFO line) and its
  step-2 loss is the unbroken runs'; ``pp2`` -> one process takes fresh
  moments with JAX's WARNING; a one-process int8 state -> pp 2 cannot
  restack (JAX's two WARNINGs, fresh moments), and that int8 run's own
  state holds its stacked leaves' moments as int8 exactly where the JAX
  package's ``int8_for`` takes the whole stacked leaf (the AdaLN
  down-projections: 1,536 elements a block, fp32 without pp, 6,144
  stacked, int8 with it).
* Video mode (``ANIMA_VIDEO_FRAMES`` 5: 2 latent frames, 3,200 tokens, the
  smallest clip of the 640 bucket) on two ranks with
  ``SEQUENCE_PARALLEL_SIZE`` 2 against one process (2 blocks, batch 1, one
  step): the loss to 2e-5 and the saved DiT; the one-process video path is held
  against JAX in ``tests/test_torch_port_anima_video.py``.
"""

import json
import re
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from aozora_sdxl_training_tpu.ckpt import train_state as jax_state
from aozora_sdxl_training_tpu.opt import adamw as jax_adamw
from aozora_sdxl_training_tpu.parallel import pipeline as jax_pl
from aozora_sdxl_training_tpu_torch.ckpt.anima_checkpoint import load_dit_state
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all, read_header
from aozora_sdxl_training_tpu_torch.ckpt.train_state import save_train_state
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
from aozora_sdxl_training_tpu_torch.data.synthetic import (
    write_random_dit_checkpoint, write_synthetic_anima_dataset)
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.opt import adamw as port_adamw

from tests.test_torch_port_ranks import finish, start, world_env

# one head of 96: the einsum attention's softmax at 1,600 tokens is most of a
# TINY step on one CPU thread, and it scales with the heads
CFG = replace(port_dit.TINY_ANIMA, in_channels=4, out_channels=4, adapter_vocab=128,
              num_blocks=4, num_heads=1)
VIDEO_CFG = replace(CFG, num_blocks=2)
STEPS, LR = 2, 1e-4
FLAT = {
    "TRAINING_MODE": "Anima DiT",
    "OUTPUT_NAME": "anima_run",
    "MAX_TRAIN_STEPS": STEPS,
    "GRADIENT_ACCUMULATION_STEPS": 1,
    "SAVE_EVERY_N_STEPS": 1,
    "SEED": 5,
    "MIXED_PRECISION": "bfloat16",
    "CLIP_GRAD_NORM": 1.0,
    "OPTIMIZER_TYPE": "raven",
    "LR_CUSTOM_CURVE": [[0.0, LR], [1.0, LR]],
    "SHOULD_UPSCALE": False,
    "ANIMA_GRADIENT_CHECKPOINTING_MODE": "Full",
    "BATCH_SIZE": 2,
    "MAX_BUCKET_RESOLUTION": 640,
}
OPTIM_STEP = re.compile(r'--- Optimizer Step:\s*(\d+)\s*\|\s*Loss:\s*([\d.e+-]+)')
PP = {"PIPELINE_PARALLEL_SIZE": 2, "ANIMA_PIPELINE_MICROBATCHES": 2}
INT8 = {"OPTIMIZER_TYPE": "paged_adamw_8bit",
        "PAGED_ADAMW_8BIT_PARAMS": {"betas": [0.9, 0.999], "eps": 1e-8,
                                    "weight_decay": 0.01, "min_8bit_size": 4096}}
RESTACKED = "INFO: Restacked resumed optimizer state for pipeline parallelism."
FRESH = ("WARNING: resumed optimizer state keys do not match the trainable set; "
         "starting with fresh moments.")
NO_RESTACK = ("WARNING: could not restack resumed optimizer state for pipeline "
              "parallelism (")


def _step_files(root: Path, run: str, step: int) -> dict:
    return {"RESUME_TRAINING": True,
            "ANIMA_RESUME_MODEL_PATH": str(root / run / f"anima_run_step_{step}.safetensors"),
            "ANIMA_RESUME_STATE_PATH": str(
                root / run / f"anima_run_training_state_step_{step}.safetensors")}


def _launch(root: Path, runs: dict) -> dict:
    """Runs {name: (ranks, flat overrides)} side by side; returns {name:
    [stdout of each rank]}."""
    procs, owners = [], []
    for name, (ranks, over) in runs.items():
        flat = {**FLAT, "DIT_PATH": str(root / "tiny_dit.safetensors"),
                "OUTPUT_DIR": str(root / name),
                "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}], **over}
        preset = root / f"{name}.json"
        preset.write_text(json.dumps(schema.nest_flat_config(flat, "anima")))
        cmd = [sys.executable, "-m", "tests.test_torch_port_ranks", "anima_cli", "65536",
               str(preset), "fp32"]
        envs = world_env(ranks, root / f"{name}_store") if ranks > 1 else [{}]
        procs += start([cmd] * ranks, root, env=envs)
        owners += [name] * ranks
    out: dict = {name: [] for name in runs}
    for name, (code, stdout, stderr) in zip(owners, finish(procs, timeout=400)):
        assert code == 0, f"{name} rank {len(out[name])} exited {code}:\n{stdout}\n{stderr}"
        out[name].append(stdout)
    return out


def _cache(root: Path, flat: dict):
    config = RuntimeConfig({**FLAT, **flat}, validate_resume_paths=False)
    with pytest.MonkeyPatch.context() as mp:
        # the cache options name the VAE source relative to the working
        # directory: write the cache from the one the CLI runs in
        mp.chdir(root)
        write_synthetic_anima_dataset(root / "data", config, n_images=2,
                                      image_size=(64, 64),
                                      source_dim=CFG.adapter_source_dim, vocab=100,
                                      latent_channels=CFG.in_channels, seed=6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The image runs (first the unbroken ones and the int8 run, then the
    resumed ones) and, in a directory of their own, the video runs
    alongside the first batch. Returns ({name: root}, {name: stdouts})."""
    root = tmp_path_factory.mktemp("port_anima_pp")
    video = root / "video"
    video.mkdir()
    write_random_dit_checkpoint(root / "tiny_dit.safetensors", CFG, seed=3)
    write_random_dit_checkpoint(video / "tiny_dit.safetensors", VIDEO_CFG, seed=3)
    _cache(root, {})
    _cache(video, {"ANIMA_VIDEO_FRAMES": 5})
    # a one-process int8 state (zero moments) for the int8 run to resume
    state, _ = load_dit_state(root / "tiny_dit.safetensors")
    params = port_dit.params_from_torch_state(state, CFG)
    opt_cfg = port_adamw.AdamWConfig(momentum_dtype="int8_blockwise")
    layout = port_adamw.Layout(port_dit.to_jax_layout, port_dit.from_jax_layout)
    (root / "int8_state").mkdir()
    save_train_state(root / "int8_state" / "anima_run_training_state_step_0.safetensors",
                     global_step=0, micro_step=0,
                     opt_state=port_adamw.init_state(params, opt_cfg, layout),
                     sampler_seed=5, sampler_epoch=0, timestep_sampler_state=None,
                     extra={"schedule_global_batch": 2})
    int8_resume = {"RESUME_TRAINING": True,
                   "ANIMA_RESUME_MODEL_PATH": str(root / "tiny_dit.safetensors"),
                   "ANIMA_RESUME_STATE_PATH": str(
                       root / "int8_state" / "anima_run_training_state_step_0.safetensors"),
                   "MAX_TRAIN_STEPS": 1}
    video_flat = {"ANIMA_VIDEO_FRAMES": 5, "BATCH_SIZE": 1, "SAVE_EVERY_N_STEPS": 0,
                  "MAX_TRAIN_STEPS": 1}
    # the pp run renders a 2-step latent-RGB preview after each optimizer
    # step (no VAE file): both stages gather for rank 0
    preview = {"ANIMA_PREVIEW_EVERY_N_STEPS": 1, "ANIMA_PREVIEW_SAMPLE_STEPS": 2}
    first = {"one": (1, {}), "pp2": (2, {**PP, **preview}),
             "pp2_int8": (2, {**PP, **INT8, **int8_resume})}
    video_runs = {"vid_one": (1, video_flat),
                  "vid_sp2": (2, {**video_flat, "SEQUENCE_PARALLEL_SIZE": 2})}
    procs_out = {}
    import threading
    thread = threading.Thread(target=lambda: procs_out.update(_launch(video, video_runs)))
    thread.start()
    try:
        out = _launch(root, first)
    finally:
        thread.join()
    out.update(_launch(root, {"one_to_pp2": (2, {**PP, **_step_files(root, "one", 1)}),
                              "pp2_to_one": (1, _step_files(root, "pp2", 1))}))
    out.update(procs_out)
    where = {name: (video if name in video_runs else root) for name in out}
    return where, out


def _losses(stdout: str) -> list:
    by_step = {int(m.group(1)): float(m.group(2)) for m in OPTIM_STEP.finditer(stdout)}
    return [by_step[s] for s in sorted(by_step)]


@pytest.mark.parametrize("name,reference,steps", [
    ("pp2", "one", [1, 2]), ("one_to_pp2", "one", [2]), ("pp2_to_one", "pp2", [2]),
    ("vid_sp2", "vid_one", [1])])
def test_losses_match_one_process(runs, name, reference, steps):
    """The resumed runs train step 2 only: the resumed pp run restored the
    one-process moments, so its loss is the unbroken runs'; the run that
    took fresh moments still starts step 2 from the same weights."""
    _, out = runs
    got, want = _losses(out[name][0]), _losses(out[reference][0])
    assert len(got) == len(steps) and all(np.isfinite(got))
    np.testing.assert_allclose(got, [want[s - 1] for s in steps], rtol=0, atol=2e-5)


@pytest.mark.parametrize("name,reference", [("pp2", "one"), ("one_to_pp2", "one"),
                                            ("vid_sp2", "vid_one")])
def test_saved_dit_matches_one_process(runs, name, reference):
    where, _ = runs
    root = where[name]
    got = load_all(root / name / "anima_run.safetensors")
    want = load_all(root / reference / "anima_run.safetensors")
    base = load_all(root / "tiny_dit.safetensors")
    assert got.keys() == want.keys() == base.keys()
    assert read_header(root / name / "anima_run.safetensors").keys() == got.keys()
    upd_got, upd_want = [], []
    for key in want:
        a, b, w0 = (np.asarray(t[key], np.float32) for t in (got, want, base))
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * 2 * LR * 1.01 + 1e-6, err_msg=key)
        upd_got.append((a - w0).ravel())
        upd_want.append((b - w0).ravel())
    upd_got, upd_want = np.concatenate(upd_got), np.concatenate(upd_want)
    cos = upd_got @ upd_want / (np.linalg.norm(upd_got) * np.linalg.norm(upd_want))
    assert cos >= 0.999


def test_pp_run_prints_and_writes_on_rank_0_only(runs):
    where, out = runs
    root = where["pp2"]
    text = out["pp2"][0]
    assert ("INFO: Pipeline parallelism: 4 DiT blocks in 2 GPipe stages x 2 "
            "microbatch(es) per dp shard (dp=1).") in text
    assert "stage-stacked block leaves over pp=2" in text
    held = re.search(r"Pipeline stages held per rank: stacked block elements "
                     r"\[(\d+), (\d+)\] of ([\d,]+)", text)
    assert held and int(held.group(1)) == int(held.group(2))
    assert 2 * int(held.group(1)) == int(held.group(3).replace(",", ""))
    assert "sharded over 2 device(s) (ZeRO)" in text
    assert "All tasks complete" in text
    assert out["pp2"][1].strip() == ""
    saved = ["anima_run.safetensors"] + [f"anima_run{kind}_step_{n}.safetensors"
                                         for kind in ("", "_training_state")
                                         for n in (1, 2)]
    assert sorted(p.name for p in (root / "pp2").glob("*.safetensors")) == sorted(saved)
    previews = sorted(p.name for p in (root / "pp2" / "previews").iterdir())
    assert previews == [f"step_{n}_latent.png" for n in (1, 2)]


def test_pp_state_has_the_jax_stacked_layout(runs):
    """The pp run's state file: the JAX package's stackify_params of the
    one-process file's keys, with its shapes (moments in the JAX layout,
    ``[num_blocks, ...]``), read by JAX's loader; its moments are the
    restacked one-process file's up to the two runs' rounding (the
    microbatches sum the gradients in another order)."""
    where, _ = runs
    root = where["pp2"]
    name = "anima_run_training_state_step_1.safetensors"
    meta_pp, pp = jax_state.load_train_state(root / "pp2" / name)
    _, one = jax_state.load_train_state(root / "one" / name)
    assert meta_pp["global_step"] == pp.step == 1
    for field in ("exp_avg", "exp_avg_sq"):
        want = jax_pl.stackify_params(getattr(one, field), CFG.num_blocks)
        got = getattr(pp, field)
        assert set(got) == set(want)
        assert any(k.startswith("__stack__.") for k in got)
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-3,
                                       atol=1e-3 * float(np.abs(w).max()), err_msg=k)


def test_resume_messages_follow_jax(runs):
    _, out = runs
    assert RESTACKED in out["one_to_pp2"][0]
    assert "INFO: Restored optimizer state from resume checkpoint." in out["one_to_pp2"][0]
    assert FRESH not in out["one_to_pp2"][0]
    assert FRESH in out["pp2_to_one"][0] and RESTACKED not in out["pp2_to_one"][0]
    int8 = out["pp2_int8"][0]
    assert NO_RESTACK in int8 and FRESH in int8 and RESTACKED not in int8


def test_pp_int8_state_decides_on_the_stacked_leaf(runs):
    """The int8 pp run's state: each stacked leaf's moments are int8 codes
    (JAX layout, with ceil(n / 256) scales) exactly where the JAX package's
    ``int8_for`` of the whole stacked leaf says so."""
    where, _ = runs
    root = where["pp2_int8"]
    _, state = jax_state.load_train_state(
        root / "pp2_int8" / "anima_run_training_state_step_1.safetensors")
    cfg = jax_adamw.AdamWConfig(momentum_dtype="int8_blockwise", min_8bit_size=4096)
    shapes = port_dit.param_shapes(CFG)
    changed = 0
    for k, m in state.exp_avg.items():
        if not k.startswith("__stack__."):
            continue
        block = shapes[f"blocks.0.{k[len('__stack__.'):]}"]
        n = CFG.num_blocks * int(np.prod(block))
        assert isinstance(m, tuple) == cfg.int8_for(n), k
        if isinstance(m, tuple):
            assert m[0].dtype == np.int8 and m[1].shape == (-(-n // 256),), k
            changed += not cfg.int8_for(int(np.prod(block)))
    assert changed >= 3      # the three AdaLN down-projections at least


def test_sdxl_trainer_refuses_pipeline_parallelism(tmp_path, monkeypatch):
    """GPipe stages the Anima DiT's blocks: where the ranks' layout takes
    pp > 1, the SDXL trainer refuses it by name (on one process the layout
    falls back to pp 1 first, as in JAX)."""
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import TINY
    from aozora_sdxl_training_tpu_torch.train import trainer
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("AOZORA_DEVICES", raising=False)
    monkeypatch.setattr(trainer, "check_if_caching_needed", lambda config: False)
    config = RuntimeConfig({**FLAT, "TRAINING_MODE": "SDXL", "PIPELINE_PARALLEL_SIZE": 2,
                            "OUTPUT_DIR": str(tmp_path / "out")}, validate_resume_paths=False)
    with pytest.raises(NotImplementedError, match="PIPELINE_PARALLEL_SIZE > 1"):
        trainer.run_sdxl_training(config, unet_cfg=TINY, device="cpu")
