"""PyTorch port: SDXL cache building and preview sampling against the JAX
package, and the user's first run (images -> cache -> training -> preview)
through the port's CLIs on the CPU.

Same numpy weights and inputs into both packages. Tolerances, each with its
reason:

* preview sampler (a stand-in model, and the TINY UNet; fp32): 1e-5 of
  the output's largest magnitude: the same fp32 function in XLA and in
  PyTorch's CPU kernels, where DDIM's division by a_t (0.068 at t=999)
  magnifies the difference in summation order;
* caches built by the real encoders of each package (fp32 CLIP towers and
  VAE encoder): 2e-2 of the payload's largest magnitude, since both store
  bf16 and a value near a rounding boundary can land one bf16 step (2^-8
  relative) apart; metadata, keys, dtypes and shapes are equal;
* caches built from one set of deterministic fake encoders: bit-identical.
"""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aozora_sdxl_training_tpu.config.runtime import RuntimeConfig as JaxConfig
from aozora_sdxl_training_tpu.data import cache_builder as jax_cb
from aozora_sdxl_training_tpu.models.sdxl.arch import TINY
from aozora_sdxl_training_tpu.train import sampler as jax_sampler
from aozora_sdxl_training_tpu_torch.cli import cache_datasets as port_cache_cli
from aozora_sdxl_training_tpu_torch.cli import train_sdxl as port_train_cli
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
from aozora_sdxl_training_tpu_torch.data import cache_builder as port_cb
from aozora_sdxl_training_tpu_torch.data import cache_store as cs
from aozora_sdxl_training_tpu_torch.data.synthetic import (
    write_image_dataset, write_random_sd_checkpoint)
from aozora_sdxl_training_tpu_torch.data.tokenization import HashTokenizer
from aozora_sdxl_training_tpu_torch.models.sdxl import vae as port_vae
from aozora_sdxl_training_tpu_torch.models.sdxl.clip import ClipTextConfig
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import params_from_jax
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port_flash
from aozora_sdxl_training_tpu_torch.train import sampler as port_sampler

from tests.test_clip_vae import _tiny_vae_sd_tensors
from tests.test_torch_port_trainer import one_thread
from tests.test_torch_port_unet import numpy_params

# tiny text towers whose widths add up to TINY's cross-attention width (48)
# and whose bigG projection is TINY's pooled width (40); the HashTokenizer's
# ids need the full 49408-entry vocabulary
CLIP_L_TINY = ClipTextConfig(width=16, num_layers=2, num_heads=1)
CLIP_G_TINY = ClipTextConfig(width=32, num_layers=2, num_heads=1,
                             activation="gelu", projection_dim=40)


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def tiny_unet():
    jparams = numpy_params(TINY, np.random.default_rng(0))
    return ({k: jnp.asarray(v) for k, v in jparams.items()}, params_from_jax(jparams))


def _conditioning(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, 8, 8, 4)).astype(np.float32),
            rng.normal(size=(1, 7, TINY.cross_attention_dim)).astype(np.float32),
            rng.normal(size=(1, TINY.pooled_projection_dim)).astype(np.float32),
            np.array([[64, 64, 0, 0, 64, 64]], np.float32))


def _stand_in_unet(xp):
    """A cheap deterministic model in place of the UNet (xp: jnp or torch),
    so that the samplers' schedules and update rules are compared alone;
    the UNet itself is held to the JAX package in test_torch_port_unet.py."""
    def forward(params, x, t, embeds, pooled, time_ids, **_):
        t = t.reshape(-1, 1, 1, 1) / 1000.0
        return (xp.tanh(x) * (0.5 + t) + 0.1 * embeds.mean() - 0.05 * pooled.mean()
                + 0.01 * time_ids.mean())
    return forward


@pytest.mark.parametrize("objective", ["epsilon", "v_prediction", "rectified_flow"])
def test_preview_sampler_matches_jax(monkeypatch, objective):
    """DDIM (eps, v) and Euler (rectified flow) over 5 steps, fp32, with a
    stand-in model."""
    monkeypatch.setattr(jax_sampler, "unet_forward", _stand_in_unet(jnp))
    monkeypatch.setattr(port_sampler, "unet_forward", _stand_in_unet(torch))
    inputs = _conditioning(1)
    want = np.asarray(jax_sampler.make_preview_sampler(
        TINY, objective, 5, compute_dtype=jnp.float32)(
            {}, *(jnp.asarray(a) for a in inputs)))
    got = port_sampler.make_preview_sampler(TINY, objective, 5,
                                            compute_dtype=torch.float32)(
        {}, *(torch.from_numpy(a) for a in inputs))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(port_sampler.ddim_schedule(5),
                                  jax_sampler.ddim_schedule(5))


def test_preview_sampler_with_tiny_unet_matches_jax(tiny_unet):
    """The v-prediction DDIM sampler through the TINY UNet, 2 steps, fp32."""
    jparams, pparams = tiny_unet
    inputs = _conditioning(2)
    want = np.asarray(jax_sampler.make_preview_sampler(
        TINY, "v_prediction", 2, compute_dtype=jnp.float32)(
            jparams, *(jnp.asarray(a) for a in inputs)))
    got = port_sampler.make_preview_sampler(TINY, "v_prediction", 2,
                                            compute_dtype=torch.float32)(
        pparams, *(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_preview_renderer_cadence_and_self_disable(tmp_path, tiny_unet, capsys):
    """Renders on multiples of PREVIEW_EVERY_N_STEPS only, from the first
    captured conditioning; a failure disables previews with a warning
    instead of ending the run (the JAX package's behaviour); flux_bn32
    latents disable it at construction."""
    _, pparams = tiny_unet
    dec = port_vae.params_from_sd_state(_tiny_vae_sd_tensors(decoder=True),
                                        include_decoder=True)
    config = SimpleNamespace(PREVIEW_EVERY_N_STEPS=2, PREVIEW_SAMPLE_STEPS=2,
                             VAE_NORMALIZATION_MODE="scalar", VAE_SHIFT_FACTOR=0.0,
                             VAE_SCALING_FACTOR=0.13025, SEED=3,
                             PREDICTION_TYPE="v_prediction")
    r = port_sampler.PreviewRenderer(config, TINY, attn_impl="xla",
                                     compute_dtype=torch.float32, decoder_params=dec)
    assert r.enabled
    _, embeds, pooled, time_ids = (torch.from_numpy(a) for a in _conditioning(3))
    r.capture_conditioning(torch.zeros(2, 4, 4, 4), embeds.repeat(2, 1, 1),
                           pooled.repeat(2, 1), time_ids.repeat(2, 1))
    r.capture_conditioning(torch.zeros(2, 8, 8, 4), embeds, pooled, time_ids)
    r.maybe_render(1, pparams, {}, tmp_path)
    assert not (tmp_path / "previews").exists()
    r.maybe_render(2, pparams, {}, tmp_path)
    with Image.open(tmp_path / "previews" / "step_2.png") as im:
        assert im.size == (32, 32)      # the first conditioning's 4x4 latents
    noise = port_sampler.preview_noise(3, 2, (1, 4, 4, 4), "cpu")
    torch.testing.assert_close(noise, port_sampler.preview_noise(3, 2, (1, 4, 4, 4), "cpu"))
    assert not torch.equal(noise, port_sampler.preview_noise(3, 4, (1, 4, 4, 4), "cpu"))

    r._sample = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
    r.maybe_render(4, pparams, {}, tmp_path)
    assert not r.enabled and not (tmp_path / "previews" / "step_4.png").exists()
    assert "preview sampling disabled after failure: RuntimeError: boom" in capsys.readouterr().out
    config.VAE_NORMALIZATION_MODE = "flux_bn32"
    assert not port_sampler.PreviewRenderer(config, TINY, attn_impl="xla",
                                            compute_dtype=torch.float32,
                                            decoder_params=dec).enabled


# --------------------------------------------------------------------------
# Cache building
# --------------------------------------------------------------------------

def _fake_text(tl, tg):
    """Deterministic stand-in towers (numpy in, numpy out): (N, 77, 12), (N, 6)."""
    tl, tg = np.asarray(tl), np.asarray(tg)
    emb = np.stack([((tl % (i + 7)) + 0.37 * (tg % (i + 3))).astype(np.float32)
                    for i in range(12)], axis=-1) / 7.0
    return emb, emb.mean(axis=1)[:, :6] + 0.01


def _fake_latents(px):
    """Average pool by 8 into 4 channels."""
    px = np.asarray(px, np.float32)
    b, h, w, _ = px.shape
    lat = px.reshape(b, h // 8, 8, w // 8, 8, 3).mean(axis=(2, 4))
    return np.concatenate([lat, lat[..., :1] * 0.5], axis=-1)


def _fake_encoders(cls, calls=None):
    def count(kind, fn):
        def run(*args):
            if calls is not None:
                calls[kind] = calls.get(kind, 0) + len(args[0])
            return fn(*args)
        return run
    tok = HashTokenizer()
    return cls(encode_text=count("text", _fake_text),
               encode_latents=count("latents", _fake_latents),
               tokenizer_l=tok, tokenizer_g=tok,
               latent_normalizer=lambda x: np.asarray(x) * 0.5)


def _snapshot(cache_dir: Path) -> dict:
    """Every payload (tensors, metadata) and the index of a cache dir."""
    out = {"index": cs.load_index(cache_dir)}
    for path in sorted(cache_dir.glob("*.safetensors")):
        out[path.name] = cs.load_payload(path)
    return out


def _configs(flat):
    return (RuntimeConfig(flat, validate_resume_paths=False),
            JaxConfig(flat, validate_resume_paths=False))


def _assert_same_cache(got: dict, want: dict, rel=None):
    assert got.keys() == want.keys()
    assert got["index"] == want["index"]
    for name in want:
        if name == "index":
            continue
        (gt, gm), (wt, wm) = got[name], want[name]
        assert gm == wm, name
        assert gt.keys() == wt.keys(), name
        for key, w in wt.items():
            g = gt[key]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (name, key)
            g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
            if rel is None:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}:{key}")
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max(),
                                           err_msg=f"{name}:{key}")


@pytest.mark.parametrize("variant", ["txt", "json_chunked_multibucket"])
def test_cache_builder_logic_matches_jax(tmp_path, variant):
    """Both packages' ``precompute_and_cache`` with the same deterministic
    encoders on the same images write the same cache, bit for bit: plain
    .txt captions with bf16 payloads; and JSON caption variants with
    caption chunking (one caption spans two CLIP windows), a multi-bucket
    extra variant per image, the null-embeds payload and fp16/fp32
    payloads. Each package accepts the other's cache."""
    root = tmp_path / "data"
    # 900x700 images take a (768, 640) bucket and an (832, 576) extra one
    write_image_dataset(root, n_images=3, image_size=(900, 700), seed=4)
    flat = {"SINGLE_FILE_CHECKPOINT_PATH": str(tmp_path / "model.safetensors"),
            "INSTANCE_DATASETS": [{"path": str(root), "repeats": 1}],
            "CACHING_BATCH_SIZE": 2, "PREDICTION_TYPE": "v_prediction",
            "MAX_BUCKET_RESOLUTION": 896}
    if variant != "txt":
        flat.update({"CAPTION_SOURCE_TYPE": "json", "CAPTION_CHUNKING_ENABLED": True,
                     "MULTI_BUCKET_ENABLED": True, "MULTI_BUCKET_EXTRA_BUCKETS": 1,
                     "UNCONDITIONAL_DROPOUT": True, "TEXT_CACHE_PRECISION": "float16",
                     "VAE_CACHE_PRECISION": "float32"})
        for i, img in enumerate(sorted(root.glob("*.png"))):
            tags = ", ".join(f"tag{j}" for j in range(100 if i == 0 else 3))
            img.with_suffix(".json").write_text(json.dumps(
                {"tags": tags, "nl": f"a picture number {i}",
                 "tags_nl": f"{tags}. a picture {i}"}))
    port_cfg, jax_cfg = _configs(flat)
    cache_dir = root / cs.sdxl_cache_dir_name(False)

    jax_cb.precompute_and_cache(jax_cfg, _fake_encoders(jax_cb.SdxlCacheEncoders),
                                force=True)
    assert port_cb.check_if_caching_needed(port_cfg) is False
    want = _snapshot(cache_dir)
    shutil.rmtree(cache_dir)
    port_cb.precompute_and_cache(port_cfg, _fake_encoders(port_cb.SdxlCacheEncoders),
                                 force=True)
    assert jax_cb.check_if_caching_needed(jax_cfg) is False
    got = _snapshot(cache_dir)
    _assert_same_cache(got, want)
    if variant != "txt":
        assert len(want["index"]["files"]) == 6          # 3 images x 2 buckets
        assert "null_embeds.safetensors" in want
        embeds = got[Path(want["index"]["files"][0]["te_path"]).name][0]["embeds"]
        assert embeds.shape[0] == 2 * 77 and embeds.dtype == np.float16


def test_incremental_rebuild_reencodes_only_what_changed(tmp_path):
    """After a caption edit the rebuild encodes that one caption and no
    latent; after an image is removed its payloads are collected."""
    root = tmp_path / "data"
    write_image_dataset(root, n_images=3, image_size=(64, 64), seed=5)
    config, _ = _configs({"SINGLE_FILE_CHECKPOINT_PATH": str(tmp_path / "m.safetensors"),
                          "INSTANCE_DATASETS": [{"path": str(root), "repeats": 1}],
                          "MAX_BUCKET_RESOLUTION": 896})
    calls = {}
    port_cb.precompute_and_cache(config, _fake_encoders(port_cb.SdxlCacheEncoders, calls))
    assert calls == {"text": 3, "latents": 3}
    assert port_cb.check_if_caching_needed(config) is False
    (root / "img1.txt").write_text("an edited caption")
    calls.clear()
    port_cb.precompute_and_cache(config, _fake_encoders(port_cb.SdxlCacheEncoders, calls))
    assert calls == {"text": 1}
    assert port_cb.check_if_caching_needed(config) is False
    for ext in (".png", ".txt"):
        (root / f"img2{ext}").unlink()
    calls.clear()
    port_cb.precompute_and_cache(config, _fake_encoders(port_cb.SdxlCacheEncoders, calls))
    cache_dir = root / cs.sdxl_cache_dir_name(False)
    assert calls == {} and len(cs.load_index(cache_dir)["files"]) == 2
    assert not list(cache_dir.glob("img2_*"))


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """A random tiny SD checkpoint (TINY UNet, tiny CLIP-L and bigG, tiny
    SD-VAE with decoder) and two captioned 64x64 images (the 640x640
    bucket), then the port's cache CLI and the port's training CLI (4 micro
    steps, GA 2, a preview every optimizer step) on the CPU."""
    root = tmp_path_factory.mktemp("first_run")
    write_random_sd_checkpoint(root / "tiny.safetensors", seed=0, unet_cfg=TINY,
                               clip_l=CLIP_L_TINY, clip_g=CLIP_G_TINY,
                               vae_channels=(8, 8, 16, 16))
    write_image_dataset(root / "data", n_images=2, image_size=(64, 64), seed=1)
    flat = {"SINGLE_FILE_CHECKPOINT_PATH": str(root / "tiny.safetensors"),
            "OUTPUT_DIR": str(root / "out"), "OUTPUT_NAME": "run",
            "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}],
            "MAX_TRAIN_STEPS": 4, "BATCH_SIZE": 1, "GRADIENT_ACCUMULATION_STEPS": 2,
            "SAVE_EVERY_N_STEPS": 0, "PREDICTION_TYPE": "v_prediction", "SEED": 3,
            "MIXED_PRECISION": "bfloat16", "PREVIEW_EVERY_N_STEPS": 1,
            "PREVIEW_SAMPLE_STEPS": 2, "MAX_BUCKET_RESOLUTION": 896}
    preset = root / "preset.json"
    preset.write_text(json.dumps(schema.nest_flat_config(flat, "sdxl")))
    return root, flat, preset


def test_caches_built_by_each_package_agree(first_run, tmp_path):
    """The real encoders of both packages (fp32 CLIP towers, fp32 VAE
    encoder) on one checkpoint and one set of images: the same payload
    files, keys, dtypes, shapes and metadata, values within the bf16
    tolerance, and each package accepts the other's cache."""
    root, flat, _ = first_run
    data = tmp_path / "data"
    shutil.copytree(root / "data", data, copy_function=shutil.copy2)
    flat = {**flat, "INSTANCE_DATASETS": [{"path": str(data), "repeats": 1}]}
    port_cfg, jax_cfg = _configs(flat)
    cache_dir = data / cs.sdxl_cache_dir_name(False)
    jax_cb.precompute_and_cache(jax_cfg, force=True)
    assert port_cb.check_if_caching_needed(port_cfg) is False
    want = _snapshot(cache_dir)
    shutil.rmtree(cache_dir)
    port_cb.precompute_and_cache(port_cfg, force=True, device="cpu")
    assert jax_cb.check_if_caching_needed(jax_cfg) is False
    got = _snapshot(cache_dir)
    _assert_same_cache(got, want, rel=2e-2)
    lat = got["img0_lat.safetensors"][0]["latents"]
    assert lat.shape == (80, 80, 4) and lat.dtype.name == "bfloat16"


def test_first_run_through_the_port_clis(first_run, monkeypatch):
    """images -> cache_datasets CLI -> train_sdxl CLI with previews on: the
    cache is built once (a second CLI run encodes nothing), training runs
    its 4 steps on it, a preview PNG is written after each optimizer step,
    and no flash kernel is involved on the CPU."""
    root, flat, preset = first_run
    monkeypatch.setenv("AOZORA_PLATFORM", "cpu")
    port_flash.reset_launch_counts()
    port_cache_cli.main(["--config", str(preset)])
    config = RuntimeConfig.from_preset_file(preset)
    assert port_cb.check_if_caching_needed(config) is False
    calls = {}
    monkeypatch.setattr(port_cb.SdxlCacheEncoders, "from_checkpoint",
                        lambda *a, **k: calls.setdefault("loaded", True))
    port_cache_cli.main(["--config", str(preset)])
    assert calls == {}
    port_train_cli.main(["--config", str(preset)])
    for step in (1, 2):
        with Image.open(root / "out" / "previews" / f"step_{step}.png") as im:
            assert im.size == (640, 640) and im.mode == "RGB"
    assert (root / "out" / "run.safetensors").exists()
    assert not any(port_flash.LAUNCHES.values())


def test_cache_cli_clear_and_anima_refusal(first_run, tmp_path, monkeypatch):
    """``--clear`` removes the active mode's cache dir; in Anima mode the
    CLI builds the Anima cache with the port's own encoders (random TINY
    Qwen3 and Wan VAE files), which its check then accepts."""
    from aozora_sdxl_training_tpu_torch.data import anima_cache
    from aozora_sdxl_training_tpu_torch.data.synthetic import (
        write_random_qwen3_checkpoint, write_random_wan_vae_checkpoint)
    from aozora_sdxl_training_tpu_torch.models.anima.qwen3 import TINY_QWEN3
    from aozora_sdxl_training_tpu_torch.models.anima.wan_vae import TINY_WAN_VAE

    root, flat, _ = first_run
    data = tmp_path / "data"
    (data / cs.sdxl_cache_dir_name(False)).mkdir(parents=True)
    preset = tmp_path / "preset.json"
    preset.write_text(json.dumps(schema.nest_flat_config(
        {**flat, "INSTANCE_DATASETS": [{"path": str(data), "repeats": 1}]}, "sdxl")))
    port_cache_cli.main(["--config", str(preset), "--clear"])
    assert not (data / cs.sdxl_cache_dir_name(False)).exists()

    shutil.copytree(root / "data", data, dirs_exist_ok=True, copy_function=shutil.copy2)
    write_random_qwen3_checkpoint(tmp_path / "qwen.safetensors", TINY_QWEN3, seed=1)
    write_random_wan_vae_checkpoint(tmp_path / "vae.safetensors", TINY_WAN_VAE, seed=2)
    nested = json.loads(preset.read_text())
    nested["active_mode"] = "anima"
    nested["anima"].update({
        "anima_text_encoder_path": str(tmp_path / "qwen.safetensors"),
        "anima_vae_path": str(tmp_path / "vae.safetensors"),
        "anima_instance_datasets": [{"path": str(data), "repeats": 1}],
        "anima_max_bucket_resolution": 640})
    preset.write_text(json.dumps(nested))
    monkeypatch.setenv("AOZORA_PLATFORM", "cpu")
    port_cache_cli.main(["--config", str(preset)])
    config = RuntimeConfig.from_preset_file(preset)
    assert anima_cache.check_if_anima_caching_needed(config) is False
    index = cs.load_index(data / anima_cache.anima_cache_dir_name(config))
    assert len(index["files"]) == 2
    lat, _ = cs.load_payload(index["files"][0]["lat_path"])
    assert lat["latents"].shape == (80, 80, TINY_WAN_VAE.z_dim)
