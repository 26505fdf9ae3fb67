"""PyTorch port: the Anima trainer and its pieces against the JAX package.

* objectives, T5 token dropout, key-prefix handling and the DiT config read
  off a checkpoint, against the JAX functions on the same numpy inputs;
* the dataset: one synthetic cache (written by the port) passes both
  packages' cache checks, and both datasets assemble the same batches;
* a short run: the JAX trainer and the port's CLI (on the CPU, with
  ``AOZORA_PLATFORM=cpu``) train one TINY DiT checkpoint on one cache for
  4 micro steps at GA 2, with one numpy noise table patched into both
  packages' noise functions, and their losses and saved DiTs agree;
* the CLI refuses to run without CUDA unless asked for the CPU, and every
  option the port does not have yet is refused by name.
"""

import json
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


@pytest.mark.parametrize("mask_hw", [None, (6, 8), (3, 4)])
def test_weighted_flowmatch_mse_matches_jax(mask_hw):
    """Sample mask always; spatial mask absent, at the error map's size, and
    at half of it (resized bilinearly in both). fp32 sums in another
    order: rtol 1e-5."""
    rng = np.random.default_rng(4)
    pred, target = (rng.normal(size=(3, 6, 8, 4)).astype(np.float32) for _ in range(2))
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
            preset = root / "preset.json"
            preset.write_text(json.dumps(schema.nest_flat_config(
                _flat(root, "out_port"), "anima")))
            port_cli.main(["--config", str(preset)])
    return root, np_params, jax_losses, port_losses


def test_losses_match_jax_trainer(runs):
    """Per-micro-step losses. Both compute the DiT in bf16, rounding at
    different places (XLA fusions vs eager ops): rtol 1e-2."""
    _, _, jax_losses, port_losses = runs
    assert len(port_losses) == len(jax_losses) == STEPS
    assert all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-2)


def test_saved_dit_matches_jax_trainer(runs):
    """Final DiT (BF16 on disk, the detected ``pipe.dit.`` prefix) after two
    optimizer steps. The bound is the one the SDXL trainer test derives:
    with debias 0.3 Adam moves an element by at most 3.63 lr in its first
    step and 4.71 lr in its second, so two runs part by at most twice the
    sum where bf16 compute noise flips a tiny gradient's sign, plus one
    bf16 ulp from the save; the whole update has the same norm (within 1%)
    and direction (cosine >= 0.95). The frozen t_embedder tensors are
    bit-identical."""
    root, np_params, _, _ = runs
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
    root, _, _, _ = runs
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
    both after a caption edit); both datasets, with null and T5 token
    dropout on, assemble the same batches from it."""
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
    with pytest.raises(NotImplementedError, match="cache_datasets"):
        port_cache.precompute_and_cache_anima(config)


# --------------------------------------------------------------------------
# CLI and refusals
# --------------------------------------------------------------------------

def test_cli_raises_without_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.delenv("AOZORA_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="AOZORA_PLATFORM=cpu"):
        port_cli.main(["--config", "missing.json"])


@pytest.mark.parametrize("overrides,match", [
    ({"RESUME_TRAINING": True}, "resume"),
    ({"ANIMA_GRADIENT_CHECKPOINTING_MODE": "Conservative"}, "Conservative"),
    ({"ANIMA_PREVIEW_EVERY_N_STEPS": 2}, "preview"),
    ({"SEQUENCE_PARALLEL_SIZE": 2}, "PARALLEL"),
    ({"PIPELINE_PARALLEL_SIZE": 2}, "PARALLEL"),
    ({"TENSOR_PARALLEL_SIZE": 2}, "PARALLEL"),
    ({"ANIMA_REPAIR_LINEART_LOSS_ENABLED": True}, "line-art"),
    ({"ANIMA_VIDEO_FRAMES": 5}, "video"),
    ({"REBUILD_CACHE": True}, "cache_datasets"),
    ({"OPTIMIZER_TYPE": "paged_adamw_8bit"}, "int8"),
])
def test_unported_options_are_refused(tmp_path, overrides, match):
    _build_env(tmp_path)
    config = RuntimeConfig(_flat(tmp_path, "out", **overrides),
                           validate_resume_paths=False)
    with pytest.raises(NotImplementedError, match=match):
        port_trainer.run_anima_training(config, device="cpu")
    assert not (tmp_path / "out" / "anima_run.safetensors").exists()


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
