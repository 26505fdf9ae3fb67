"""PyTorch port: the Anima trainer and its pieces against the JAX package.

* objectives, T5 token dropout, key-prefix handling and the DiT config read
  off a checkpoint, against the JAX functions on the same numpy inputs;
* the dataset: one synthetic cache (written by the port) passes both
  packages' cache checks, and both datasets assemble the same batches;
* a short run: the JAX trainer and the port's CLI (on the CPU, with
  ``AOZORA_PLATFORM=cpu``) train one TINY DiT checkpoint on one cache for
  4 micro steps at GA 2, with one numpy noise table patched into both
  packages' noise functions, and their losses and saved DiTs agree; the
  port saves at each optimizer step and, within the same patches, resumes
  from optimizer step 1's files with the unbroken run's losses;
* the CLI refuses to run without CUDA unless asked for the CPU, the
  multi-rank options fall back on one process as in JAX, and each forced
  low-memory rung runs, saves and prints the JAX planner's lines.
"""

import contextlib
import io
import json
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aozora_sdxl_training_tpu.train.reporter as jax_reporter
from aozora_sdxl_training_tpu.ckpt import anima_checkpoint as jax_ckpt
from aozora_sdxl_training_tpu.config.runtime import RuntimeConfig as JaxConfig
from aozora_sdxl_training_tpu.data import anima_cache as jax_cache
from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.train import anima_objectives as jax_obj
from aozora_sdxl_training_tpu.train import objectives as jax_sdxl_obj
from aozora_sdxl_training_tpu.train.anima_trainer import (
    _dit_config_for_state as jax_dit_config_for_state, run_anima_training)
from aozora_sdxl_training_tpu_torch.ckpt import anima_checkpoint as port_ckpt
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import (
    load_all, read_header, write_streaming)
from aozora_sdxl_training_tpu_torch.cli import train_anima as port_cli
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
from aozora_sdxl_training_tpu_torch.data import anima_cache as port_cache
from aozora_sdxl_training_tpu_torch.data import cache_store as cs
from aozora_sdxl_training_tpu_torch.data.synthetic import write_synthetic_anima_dataset
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
import aozora_sdxl_training_tpu_torch.train.reporter as port_reporter
from aozora_sdxl_training_tpu_torch.train import anima_objectives as port_obj
from aozora_sdxl_training_tpu_torch.train import anima_trainer as port_trainer
from aozora_sdxl_training_tpu_torch.train import objectives as port_sdxl_obj

from tests.test_torch_port_anima_dit import numpy_params
from tests.test_torch_port_trainer import one_thread

CFG = jax_dit.TINY_ANIMA
LAT, LS, STEPS, GA = 8, 12, 4, 2
LR = 1e-4
FLAT = {
    "TRAINING_MODE": "Anima DiT",
    "OUTPUT_NAME": "anima_run",
    "MAX_TRAIN_STEPS": STEPS,
    "BATCH_SIZE": 1,
    "GRADIENT_ACCUMULATION_STEPS": GA,
    "SAVE_EVERY_N_STEPS": 0,
    "SEED": 5,
    "DIT_EXCLUDE_TARGETS": "t_embedder",
    "MIXED_PRECISION": "bfloat16",
    "CLIP_GRAD_NORM": 1.0,
    "OPTIMIZER_TYPE": "raven",
    "LR_CUSTOM_CURVE": [[0.0, LR], [1.0, LR]],
    "ANIMA_DIT_SAVE_PREFIX": "auto",
}


# --------------------------------------------------------------------------
# Objectives, dropout, prefixes
# --------------------------------------------------------------------------

def test_sigma_table_and_flowmatch_targets_match_jax():
    np.testing.assert_array_equal(port_obj.anima_sigma_table(),
                                  jax_obj.anima_sigma_table())
    tickets = np.asarray([0, 1, 500, 998, 999, 1200, -3], np.int32)
    sig, ts = port_obj.ticket_to_sigma_timestep(torch.from_numpy(tickets))
    want_sig, want_ts = jax_obj.ticket_to_sigma_timestep(jnp.asarray(tickets))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(want_sig))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(want_ts))
    rng = np.random.default_rng(2)
    lat, noise = (rng.normal(size=(3, 4, 5, 6)).astype(np.float32) for _ in range(2))
    s = np.asarray([0.1, 0.5, 0.93], np.float32)
    got = port_obj.flowmatch_noise_and_target(*map(torch.from_numpy, (lat, noise, s)))
    want = jax_obj.flowmatch_noise_and_target(*map(jnp.asarray, (lat, noise, s)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mask_hw,frames", [
    (None, 0), ((6, 8), 0), ((3, 4), 0), (None, 3), ((3, 4), 3)],
    ids=["None", "mask_hw1", "mask_hw2", "video-None", "video-mask_hw2"])
def test_weighted_flowmatch_mse_matches_jax(mask_hw, frames):
    """Sample mask always; spatial mask absent, at the error map's size, and
    at half of it (resized bilinearly in both); NHWC maps, and NTHWC ones of
    3 frames (video mode: one mask a clip, over every frame). fp32 sums in
    another order: rtol 1e-5."""
    rng = np.random.default_rng(4)
    shape = (3,) + ((frames,) if frames else ()) + (6, 8, 4)
    pred, target = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    weights = np.asarray([1.0, 0.5, 2.0], np.float32)
    sample_mask = np.asarray([1.0, 1.0, 0.0], np.float32)
    spatial = (None if mask_hw is None else
               rng.uniform(size=(3,) + mask_hw).astype(np.float32))
    got = port_obj.weighted_flowmatch_mse(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(weights),
        sample_mask=torch.from_numpy(sample_mask),
        spatial_mask=None if spatial is None else torch.from_numpy(spatial),
        spatial_strength=0.5)
    want = jax_obj.weighted_flowmatch_mse(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weights),
        sample_mask=jnp.asarray(sample_mask),
        spatial_mask=None if spatial is None else jnp.asarray(spatial),
        spatial_strength=0.5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


class _DropoutCfg:
    T5_TOKEN_DROPOUT_ENABLED = True
    T5_TOKEN_DROPOUT_CHANCE = 0.7
    T5_TOKEN_DROPOUT_MIN = 0.2
    T5_TOKEN_DROPOUT_MAX = 0.6
    SEED = 7


@pytest.mark.parametrize("enabled", [True, False])
def test_t5_token_dropout_matches_jax(enabled):
    cfg = _DropoutCfg()
    cfg.T5_TOKEN_DROPOUT_ENABLED = enabled
    ids = np.concatenate([np.arange(1, 31), np.zeros(10)]).astype(np.int32)
    batch = np.stack([ids, ids[::-1].copy()])
    for caption in ("a cat", "a dog", "", "long caption with many words"):
        np.testing.assert_array_equal(
            port_obj.apply_t5_token_dropout(ids, caption, cfg),
            jax_obj.apply_t5_token_dropout(ids, caption, cfg))
    caps = ["x", "y"]
    np.testing.assert_array_equal(port_obj.apply_t5_token_dropout(batch, caps, cfg),
                                  jax_obj.apply_t5_token_dropout(batch, caps, cfg))


def test_strip_prefix_and_save_prefix_match_jax():
    states = [{f"pipe.dit.layer{i}": i for i in range(9)} | {"other": 1},
              {f"pipe.dit.a{i}": i for i in range(3)} | {f"x{i}": i for i in range(3)},
              {f"net.b{i}": i for i in range(5)},
              {f"model.diffusion_model.c{i}": i for i in range(4)}, {}]
    for state in states:
        assert port_ckpt.strip_prefix(state, port_ckpt.DIT_PREFIXES) == \
            jax_ckpt.strip_prefix(state, jax_ckpt.DIT_PREFIXES)

    class Cfg:
        pass

    for requested in ("auto", "AUTO", "", "model.diffusion_model", "net."):
        cfg = Cfg()
        cfg.ANIMA_DIT_SAVE_PREFIX = requested
        for detected in ("pipe.dit.", ""):
            assert port_ckpt.resolve_save_prefix(cfg, detected) == \
                jax_ckpt.resolve_save_prefix(cfg, detected)


# --------------------------------------------------------------------------
# Environment: TINY checkpoint + cache
# --------------------------------------------------------------------------

def _build_env(root: Path):
    """TINY DiT checkpoint (fp32, torch layout, ``pipe.dit.`` prefix) and a
    cache of three 8 x 8 latents; returns the JAX-layout numpy params."""
    rng = np.random.default_rng(21)
    np_params = numpy_params(CFG, rng)
    state = port_dit.params_to_torch_state(port_dit.params_from_jax(np_params))
    write_streaming(root / "tiny_dit.safetensors",
                    {f"pipe.dit.{k}": v.numpy() for k, v in state.items()})
    cache_dir = root / "data" / ".precomputed_anima_dit_cache"
    files = []
    for i in range(3):
        te_path, lat_path = cs.te_path_for(cache_dir, f"img{i}"), cs.lat_path_for(cache_dir, f"img{i}")
        cs.save_payload(te_path, {
            "prompt_emb": rng.normal(size=(LS, CFG.adapter_source_dim)).astype(np.float32),
            "t5xxl_ids": rng.integers(1, CFG.adapter_vocab, LS).astype(np.int32),
        }, {"caption": f"cap {i}"})
        cs.save_payload(lat_path, {
            "latents": (rng.normal(size=(LAT, LAT, CFG.in_channels)) * 0.3).astype(np.float32),
        }, {})
        files.append({"te_path": str(te_path), "lat_path": str(lat_path),
                      "relative_path": f"img{i}.png", "original_size": [64, 64],
                      "scaled_size": [64, 64], "target_size": [64, 64],
                      "crop_coords": [0, 0], "bucket_variant_index": 0})
    cs.save_index(cache_dir, {"version": 6, "cache_options": {}, "files": files})
    return np_params


def _flat(root: Path, out: str, **overrides) -> dict:
    return {**FLAT, "DIT_PATH": str(root / "tiny_dit.safetensors"),
            "OUTPUT_DIR": str(root / out),
            "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}],
            **overrides}


def _recording(reporter_cls, losses):
    original = reporter_cls.log_step

    def log_step(self, micro_step, *, loss, **kw):
        losses.append(loss)
        return original(self, micro_step, loss=loss, **kw)
    return log_step


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_anima_trainer")
    np_params = _build_env(root)
    noise = np.random.default_rng(5).normal(
        size=(STEPS + 1, 1, LAT, LAT, CFG.in_channels)).astype(np.float32)
    table = jnp.asarray(noise)
    jax_losses, port_losses = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AOZORA_DEVICES", "1")
        mp.setenv("AOZORA_PLATFORM", "cpu")
        mp.setattr(jax_sdxl_obj, "noise_for_step", lambda seed, ms, shape: table[ms])
        mp.setattr(port_sdxl_obj, "noise_for_step",
                   lambda seed, ms, shape, device: torch.from_numpy(noise[ms]).to(device))
        mp.setattr(jax_reporter.MetricsReporter, "log_step",
                   _recording(jax_reporter.MetricsReporter, jax_losses))
        mp.setattr(port_reporter.MetricsReporter, "log_step",
                   _recording(port_reporter.MetricsReporter, port_losses))
        # the cache has no source images: skip both rebuild checks
        with mock.patch("aozora_sdxl_training_tpu.train.anima_trainer."
                        "check_if_anima_caching_needed", return_value=False), \
                mock.patch("aozora_sdxl_training_tpu_torch.train.anima_trainer."
                           "check_if_anima_caching_needed", return_value=False):
            run_anima_training(JaxConfig(_flat(root, "out_jax"),
                                         validate_resume_paths=False))
            stdout = {}
            for name, flat in (
                    ("port", _flat(root, "out_port", SAVE_EVERY_N_STEPS=1)),
                    ("resumed", _flat(
                        root, "out_resumed", SAVE_EVERY_N_STEPS=1, RESUME_TRAINING=True,
                        ANIMA_RESUME_MODEL_PATH=str(root / "out_port" / "anima_run_step_1.safetensors"),
                        ANIMA_RESUME_STATE_PATH=str(
                            root / "out_port" / "anima_run_training_state_step_1.safetensors")))):
                preset = root / f"{name}.json"
                preset.write_text(json.dumps(schema.nest_flat_config(flat, "anima")))
                out = io.StringIO()
                with one_thread(), contextlib.redirect_stdout(out):
                    port_cli.main(["--config", str(preset)])
                stdout[name] = out.getvalue()
    return root, np_params, jax_losses, port_losses, stdout


def test_losses_match_jax_trainer(runs):
    """Per-micro-step losses. Both compute the DiT in bf16, rounding at
    different places (XLA fusions vs eager ops): rtol 1e-2."""
    _, _, jax_losses, port_losses, _ = runs
    assert len(port_losses) == STEPS + STEPS - GA and len(jax_losses) == STEPS
    assert all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses[:STEPS], jax_losses, rtol=1e-2)


def test_resumed_run_reproduces_the_unbroken_run(runs):
    """Resumed from optimizer step 1's DiT and training state, the port runs
    micro steps 3-4 with the unbroken run's losses: rtol 1e-2 (the DiT file
    holds bf16-rounded masters, 2^-9 of a weight at most, which moves a
    TINY loss by well under 1%); the optimizer step counter goes on at 2,
    and the step-2 files are written beside the final DiT."""
    root, _, _, port_losses, stdout = runs
    got, want = port_losses[STEPS:], port_losses[GA:STEPS]
    print(f"first resumed step's loss {got[0]!r} against {want[0]!r} (relative "
          f"difference {abs(got[0] - want[0]) / want[0]:.3e})")
    np.testing.assert_allclose(got, want, rtol=1e-2)
    out = stdout["resumed"]
    assert "--- RESUMING TRAINING SESSION ---" in out
    assert "INFO: Restored optimizer state from resume checkpoint." in out
    assert [int(m) for m in re.findall(r"--- Optimizer Step: (\d+)", out)] == [2]
    assert sorted(p.name for p in (root / "out_resumed").glob("*.safetensors")) == [
        "anima_run.safetensors", "anima_run_step_2.safetensors",
        "anima_run_training_state_step_2.safetensors"]


def test_saved_dit_matches_jax_trainer(runs):
    """Final DiT (BF16 on disk, the detected ``pipe.dit.`` prefix) after two
    optimizer steps. The bound is the one the SDXL trainer test derives:
    with debias 0.3 Adam moves an element by at most 3.63 lr in its first
    step and 4.71 lr in its second, so two runs part by at most twice the
    sum where bf16 compute noise flips a tiny gradient's sign, plus one
    bf16 ulp from the save; the whole update has the same norm (within 1%)
    and direction (cosine >= 0.95). The frozen t_embedder tensors are
    bit-identical."""
    root, np_params, _, _, _ = runs
    port = load_all(root / "out_port" / "anima_run.safetensors")
    ref = load_all(root / "out_jax" / "anima_run.safetensors")
    assert port.keys() == ref.keys() == {f"pipe.dit.{k}" for k in np_params}
    header = read_header(root / "out_port" / "anima_run.safetensors")
    assert all(v["dtype"] == "BF16" for v in header.values())
    base = {f"pipe.dit.{k}": v.numpy() for k, v in
            port_dit.params_from_jax(np_params).items()}
    upd_port, upd_ref = [], []
    for key in ref:
        a = np.asarray(port[key], np.float32)
        b = np.asarray(ref[key], np.float32)
        if ".t_embedder." in key:
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7,
                                   atol=2 * (3.63 + 4.71) * LR * 1.01, err_msg=key)
        upd_port.append((a - base[key]).ravel())
        upd_ref.append((b - base[key]).ravel())
    upd_port, upd_ref = np.concatenate(upd_port), np.concatenate(upd_ref)
    norm_port, norm_ref = np.linalg.norm(upd_port), np.linalg.norm(upd_ref)
    assert norm_port == pytest.approx(norm_ref, rel=1e-2)
    assert upd_port @ upd_ref / (norm_port * norm_ref) >= 0.95


def test_dit_config_read_off_the_checkpoint_matches_jax(runs):
    root = runs[0]
    state, prefix = port_ckpt.load_dit_state(root / "tiny_dit.safetensors")
    assert prefix == "pipe.dit."
    got = port_trainer._dit_config_for_state(state)
    want = jax_dit_config_for_state(state)
    assert {k: getattr(got, k) for k in want.__dataclass_fields__} == \
        {k: getattr(want, k) for k in want.__dataclass_fields__}


# --------------------------------------------------------------------------
# Dataset
# --------------------------------------------------------------------------

def test_dataset_batches_match_jax_from_one_synthetic_cache(tmp_path):
    """The port's synthetic Anima cache passes both cache checks (and fails
    both after a caption edit, until the port's builder re-encodes that one
    caption); both datasets, with null and T5 token dropout on, assemble the
    same batches from it."""
    flat = {**FLAT, "DIT_PATH": str(tmp_path / "none.safetensors"),
            "INSTANCE_DATASETS": [{"path": str(tmp_path / "d"), "repeats": 2}],
            "T5_TOKEN_DROPOUT_ENABLED": True, "T5_TOKEN_DROPOUT_CHANCE": 0.8,
            "T5_TOKEN_DROPOUT_MIN": 0.1, "T5_TOKEN_DROPOUT_MAX": 0.5,
            "QWEN_NULL_DROPOUT_CHANCE": 0.4, "T5_NULL_DROPOUT_CHANCE": 0.4}
    config = RuntimeConfig(flat, validate_resume_paths=False)
    jax_config = JaxConfig(flat, validate_resume_paths=False)
    cache_dir = write_synthetic_anima_dataset(
        tmp_path / "d", config, n_images=3, image_size=(64, 64), source_dim=32,
        vocab=CFG.adapter_vocab, latent_channels=4, seed=9)
    rng = np.random.default_rng(1)
    cs.save_payload(cache_dir / "null_embeds.safetensors", {
        "prompt_emb": np.zeros((16, 32), np.float32),
        "t5xxl_ids": rng.integers(1, 9, 16).astype(np.int32)},
        {"cache_options": port_cache.anima_cache_options(config)})
    assert port_cache.check_if_anima_caching_needed(config) is False
    assert jax_cache.check_if_anima_caching_needed(jax_config) is False

    port_ds = port_cache.AnimaLatentDataset(config)
    jax_ds = jax_cache.AnimaLatentDataset(jax_config)
    assert port_ds.bucket_keys == jax_ds.bucket_keys == [(768, 768)] * 6
    packed = [[(s << 32) | (s % 6)] for s in range(8)] + [[1, (3 << 32) | 4]]
    for batch in packed:
        got, want = port_ds.fetch_batch(batch), jax_ds.fetch_batch(batch)
        assert got.keys() == want.keys() == {"latents", "prompt_emb", "t5xxl_ids"}
        for key in got:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["latents"].shape == (2, 96, 96, 4)
    assert got["t5xxl_ids"].shape == (2, port_cache.CONTEXT_TOKENS)

    (tmp_path / "d" / "img1.txt").write_text("edited caption")
    assert port_cache.check_if_anima_caching_needed(config) is True
    assert jax_cache.check_if_anima_caching_needed(jax_config) is True
    # the port rebuilds it: the edited caption alone is encoded, and both
    # checks accept the cache again; the line-art option makes both ask for
    # a rebuild (its masks ride the latent payloads)
    calls = []

    def encode_prompt(captions):
        calls.extend(captions)
        return ([np.full((port_cache.CONTEXT_TOKENS, 32), 0.5, np.float32)] * len(captions),
                [np.arange(1, 9, dtype=np.int32)] * len(captions))

    def encode_image(pixels):
        raise AssertionError("a latent was encoded again")

    encoders = port_cache.AnimaCacheEncoders(encode_prompt=encode_prompt,
                                             encode_image=encode_image)
    port_cache.precompute_and_cache_anima(config, encoders)
    assert calls == ["edited caption"]
    assert port_cache.check_if_anima_caching_needed(config) is False
    assert jax_cache.check_if_anima_caching_needed(jax_config) is False
    lineart = {**flat, "ANIMA_REPAIR_LINEART_LOSS_ENABLED": True}
    assert port_cache.check_if_anima_caching_needed(
        RuntimeConfig(lineart, validate_resume_paths=False)) is True
    assert jax_cache.check_if_anima_caching_needed(
        JaxConfig(lineart, validate_resume_paths=False)) is True


# --------------------------------------------------------------------------
# CLI and refusals
# --------------------------------------------------------------------------

def test_cli_raises_without_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.delenv("AOZORA_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="AOZORA_PLATFORM=cpu"):
        port_cli.main(["--config", "missing.json"])


@pytest.mark.parametrize("overrides", [
    {"PIPELINE_PARALLEL_SIZE": 2},
    {"PIPELINE_PARALLEL_SIZE": 2, "ANIMA_PIPELINE_MICROBATCHES": 3},
    {"SEQUENCE_PARALLEL_SIZE": 2, "PIPELINE_PARALLEL_SIZE": 2},
    {"TENSOR_PARALLEL_SIZE": 2},
    {"SEQUENCE_PARALLEL_SIZE": 2, "TENSOR_PARALLEL_SIZE": 2},
], ids=["pp2", "pp2_microbatches_3", "sp2_pp2", "tp2", "sp2_tp2"])
def test_multi_rank_options_fall_back_on_one_process(tmp_path, monkeypatch, capsys,
                                                      overrides):
    """Pipeline, sequence and tensor parallelism are ported (on ranks:
    ``tests/test_torch_port_anima_pp.py``, ``test_torch_port_anima_sp.py``,
    ``test_torch_port_tp_ranks.py``); on one process the layout falls back
    as the JAX package's does, with its WARNING lines (tp alone: it does
    not divide 1 device; sp with tp: they cannot combine; the microbatch
    count is not checked once pp is 1), and the run trains."""
    _build_env(tmp_path)
    monkeypatch.setenv("AOZORA_DEVICES", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    from aozora_sdxl_training_tpu.parallel import sharding as jax_shard
    jax_shard.resolve_mesh_layout(JaxConfig(_flat(tmp_path, "out", **overrides),
                                            validate_resume_paths=False))
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("WARNING")]
    config = RuntimeConfig(_flat(tmp_path, "out", **overrides), validate_resume_paths=False)
    with mock.patch("aozora_sdxl_training_tpu_torch.train.anima_trainer."
                    "check_if_anima_caching_needed", return_value=False), one_thread():
        port_trainer.run_anima_training(config, device="cpu")
    got = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("WARNING")]
    assert want and got == want
    assert (tmp_path / "out" / "anima_run.safetensors").exists()


def test_rebuild_cache_builds_on_the_device_before_the_dit_loads(tmp_path):
    """REBUILD_CACHE: the trainer builds the cache on its device first, and
    the DiT loads after it; a multi-rank run asks for the cache CLI
    instead."""
    _build_env(tmp_path)
    config = RuntimeConfig(_flat(tmp_path, "out", REBUILD_CACHE=True),
                           validate_resume_paths=False)
    order = []

    class DitLoaded(Exception):
        pass

    def load_dit_state(path):
        order.append(("dit", path))
        raise DitLoaded

    with mock.patch.object(port_trainer, "precompute_and_cache_anima",
                           side_effect=lambda cfg, device: order.append(("cache", device))), \
            mock.patch.object(port_trainer, "load_dit_state", side_effect=load_dit_state):
        with pytest.raises(DitLoaded):
            port_trainer.run_anima_training(config, device="cpu")
        assert order == [("cache", torch.device("cpu")), ("dit", config.DIT_PATH)]
        with mock.patch.object(port_trainer.shard, "world_size", return_value=2):
            with pytest.raises(RuntimeError, match="cache_datasets"):
                port_trainer.run_anima_training(config, device="cpu")


@pytest.mark.parametrize("rung", ["two_pass", "moments_host"])
def test_forced_rung_runs_saves_and_prints_the_jax_plan(tmp_path, monkeypatch, rung):
    """``AOZORA_LOWMEM_RUNG`` at GA 1 under Conservative: the CLI runs the
    rung's step for two optimizer steps with finite losses, saves the DiT
    and the training state at each, and prints the JAX planner's lines for
    that rung on the same inputs."""
    from tests.test_torch_port_fused_step import _plan_lines
    from tests.test_torch_port_memory_policy import jax_plan_lines, recorded_plans
    _build_env(tmp_path)
    monkeypatch.setenv("AOZORA_LOWMEM_RUNG", rung)
    monkeypatch.setenv("AOZORA_PLATFORM", "cpu")
    monkeypatch.setenv("AOZORA_DEVICES", "1")
    preset = tmp_path / "rung.json"
    preset.write_text(json.dumps(schema.nest_flat_config(_flat(
        tmp_path, "out", GRADIENT_ACCUMULATION_STEPS=1, MAX_TRAIN_STEPS=2,
        SAVE_EVERY_N_STEPS=1, ANIMA_GRADIENT_CHECKPOINTING_MODE="Conservative"), "anima")))
    out = io.StringIO()
    with recorded_plans() as plans, one_thread(), contextlib.redirect_stdout(out), \
            mock.patch.object(port_trainer, "check_if_anima_caching_needed",
                              return_value=False):
        port_cli.main(["--config", str(preset)])
    out = out.getvalue()
    lines = _plan_lines(out)
    assert lines == jax_plan_lines("anima", plans["anima"][0])
    assert ("two-pass step" in lines[2]) == (rung == "two_pass")
    assert ("OFFLOADED to pinned host memory" in lines[3]) == (rung == "moments_host")
    assert "remat: conservative" in lines[4]
    losses = [float(m) for m in re.findall(r"--- Optimizer Step: \d+\s*\| Loss: ([\d.]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all((tmp_path / "out" / f"anima_run{kind}_step_{n}.safetensors").exists()
               for kind in ("", "_training_state") for n in (1, 2))
    assert (tmp_path / "out" / "anima_run.safetensors").exists()


@pytest.mark.parametrize("master", ["auto", "float32"])
def test_fp32_master_dtypes_pass_the_check(tmp_path, master):
    config = RuntimeConfig(_flat(tmp_path, "out", MASTER_DTYPE=master),
                           validate_resume_paths=False)
    assert config.MASTER_DTYPE == master


def test_profiler_traces_micro_steps_3_to_8(tmp_path, monkeypatch):
    """AOZORA_PROFILE_DIR: the trace starts before micro step 3, ends after
    micro step 8, and writes the trace, the kernel table and the summary
    under the trainer's name; without the variable nothing is traced."""
    from aozora_sdxl_training_tpu_torch.train.profiling import StepProfiler
    monkeypatch.delenv("AOZORA_PROFILE_DIR", raising=False)
    assert StepProfiler.from_env("anima").dir is None
    monkeypatch.setenv("AOZORA_PROFILE_DIR", str(tmp_path))
    prof = StepProfiler.from_env("anima")
    x = torch.ones(64, 64)
    messages = []
    for step in range(1, 10):
        prof.before_step(step)
        x = x @ x / 64
        messages.append(prof.after_step(step))
    assert [m is not None for m in messages] == [s == 8 for s in range(1, 10)]
    out = tmp_path / "anima"
    summary = json.loads((out / "summary.json").read_text())
    assert summary["micro_steps"] == [3, 8] and summary["wall_s"] > 0
    assert (out / "trace.json.gz").stat().st_size > 0
    assert "aten::mm" in (out / "kernels.txt").read_text()
