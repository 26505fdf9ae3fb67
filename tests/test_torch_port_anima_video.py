"""PyTorch port: Anima video mode and the Anima preview sampler against the
JAX package.

Same numpy weights and inputs through both packages on the CPU at TINY
sizes, fp32:

* the Wan VAE's video encode, video decode and image decode, on a full
  TINY Wan file (5-D causal kernels with random temporal slices, the
  temporal ``time_conv`` kernels of both halves) read by the JAX loader and
  carried across with ``params_from_jax``; a one-frame clip encodes as the
  image does in both packages;
* the clip loader (an animated WEBP shorter than the request loops);
* the DiT at two latent frames, forward and parameter gradients;
* the preview sampler (Euler over the DiT) at one and two latent frames on
  the same noise, and the latent-RGB picture; the port's renderer's three
  outputs (filmstrip, first frame, latent-RGB) and its failure path;
* the memory plan of a video config (``ANIMA_VIDEO_FRAMES`` 9), through
  both trainers;
* a TINY video run through the port's CLIs (clips -> cache CLI -> Anima
  CLI with a preview every optimizer step), in a fresh interpreter that
  never imports JAX; its stdout replayed through the GUI's grammar; and the
  JAX package's clips cache from the same two clips, each package's check
  accepting the other's.

Tolerances, each with its reason:

* modules: 1e-4 of the reference's largest magnitude (the same fp32
  function by XLA and by PyTorch's CPU kernels, summed in other orders);
  the DiT forward rtol 2e-4 / atol 2e-5 and its gradients 1e-4 of each
  tensor's largest, as ``test_torch_port_anima_dit.py`` holds them; the
  sampler 2e-4 of the largest magnitude (three DiT forwards composed);
* caches: 2e-2 of the payload's largest magnitude (both store bf16; a
  value near a rounding boundary can land one bf16 step apart).
"""

import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aozora_sdxl_training_tpu.config.runtime import RuntimeConfig as JaxConfig
from aozora_sdxl_training_tpu.data import anima_cache as jax_cache
from aozora_sdxl_training_tpu.data import image_prep as jax_prep
from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.models.anima import wan_vae as jax_wan
from aozora_sdxl_training_tpu.train import anima_sampler as jax_sampler
from aozora_sdxl_training_tpu.train import memory_policy as jax_mp
from aozora_sdxl_training_tpu.train.anima_trainer import run_anima_training
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
from aozora_sdxl_training_tpu_torch.data import anima_cache as port_cache
from aozora_sdxl_training_tpu_torch.data import image_prep as port_prep
from aozora_sdxl_training_tpu_torch.data.synthetic import (
    write_clip_dataset, write_random_dit_checkpoint, write_random_qwen3_checkpoint,
    write_random_wan_vae_checkpoint)
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.models.anima import qwen3 as port_qwen3
from aozora_sdxl_training_tpu_torch.models.anima import wan_vae as port_wan
from aozora_sdxl_training_tpu_torch.train import anima_sampler as port_sampler
from aozora_sdxl_training_tpu_torch.train import anima_trainer as port_trainer

from tests.test_gui_grammar import (ANIMA_PROGRESS, SDXL_PROGRESS, _audit,
                                    _gui_lines)
from tests.test_torch_port_anima_cache import _close
from tests.test_torch_port_anima_dit import _worst, numpy_params
from tests.test_torch_port_anima_trainer import _build_env, _flat as _trainer_flat
from tests.test_torch_port_cache_preview import _configs, _snapshot
from tests.test_torch_port_memory_policy import _same
from tests.test_torch_port_trainer import one_thread

REPO = Path(__file__).resolve().parents[1]
V_CFG = jax_wan.TINY_WAN_VAE
# the TINY DiT on the TINY Wan VAE's latent channels
DIT = replace(jax_dit.TINY_ANIMA, in_channels=V_CFG.z_dim, out_channels=V_CFG.z_dim)
PORT_DIT = replace(port_dit.TINY_ANIMA, in_channels=V_CFG.z_dim, out_channels=V_CFG.z_dim)
LS = 12


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``); the JAX side's threads are XLA's."""
    with one_thread():
        yield


# --------------------------------------------------------------------------
# Wan VAE: video encode, decoder
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wan():
    """A full TINY Wan file's tensors in torch layout (numpy fp32, seed 11):
    N(0, 1/fan_in) kernels, the 3x3x3 causal ones with every temporal slice
    random, random biases and gammas. Returns the JAX loader's params and
    the port's (``params_from_jax`` of them)."""
    rng = np.random.default_rng(11)
    shapes = {**port_wan.param_shapes(port_wan.TINY_WAN_VAE),
              **port_wan.decoder_param_shapes(port_wan.TINY_WAN_VAE, video=True)}
    state = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            a = rng.normal(scale=0.05, size=shape)
        elif name.endswith(".gamma"):
            a = 1.0 + rng.normal(scale=0.1, size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        state[f"model.{name}"] = a.astype(np.float32)
    jax_params = jax_wan.params_from_torch_state(state, V_CFG, include_decoder=True)
    port_params = port_wan.params_from_jax({k: np.asarray(v) for k, v in jax_params.items()})
    loaded = port_wan.params_from_torch_state(state, include_decoder=True)
    assert loaded.keys() == port_params.keys()
    assert all(torch.equal(loaded[k], port_params[k]) for k in loaded)
    return jax_params, port_params


def _jit(fn):
    return jax.jit(lambda p, x: fn(p, x, cfg=V_CFG))


def test_param_shapes_match_jax():
    """The port's Wan-file layout names the JAX package's tensors, with
    the same (out, in) channels: the encoder with its ``time_conv`` kernels
    and the decoder with and without them."""
    cfg = port_wan.TINY_WAN_VAE
    for port_shapes, jax_shapes in (
            (port_wan.param_shapes(cfg), jax_wan.param_shapes(V_CFG, video=True)),
            (port_wan.decoder_param_shapes(cfg), jax_wan.decoder_param_shapes(V_CFG)),
            (port_wan.decoder_param_shapes(cfg, video=True),
             jax_wan.decoder_param_shapes(V_CFG, video=True))):
        assert port_shapes.keys() == jax_shapes.keys()
        for name, want in jax_shapes.items():
            got = port_shapes[name]
            if len(want) == 1:
                assert got[0] == want[0], name
            else:
                assert (got[0], got[1]) == (want[-1], want[-2]), name


@pytest.mark.parametrize("frames", [5, 9])
def test_video_encode_and_decode_match_jax(wan, frames):
    """A clip of 5 or 9 frames at 16 x 24 px: ``encode_video`` (1 + k latent
    frames), then ``decode_video`` of JAX's latents (1 + 4k frames) and
    ``decode_image`` of their first frame."""
    jax_params, port_params = wan
    cfg = port_wan.TINY_WAN_VAE
    clip = np.random.default_rng(frames).uniform(
        -1, 1, size=(1, frames, 16, 24, 3)).astype(np.float32)
    want = np.asarray(_jit(jax_wan.encode_video)(jax_params, jnp.asarray(clip)))
    got = port_wan.encode_video(port_params, torch.from_numpy(clip), cfg=cfg)
    assert want.shape == (1, 1 + (frames - 1) // 4, 2, 3, V_CFG.z_dim)
    _close(got, want)
    got = port_wan.decode_video(port_params, torch.from_numpy(want.copy()), cfg=cfg)
    assert got.shape == (1, frames, 16, 24, 3)
    _close(got, _jit(jax_wan.decode_video)(jax_params, jnp.asarray(want)))
    first = want[:, 0].copy()
    _close(port_wan.decode_image(port_params, torch.from_numpy(first), cfg=cfg),
           _jit(jax_wan.decode_image)(jax_params, jnp.asarray(first)))


def test_one_frame_clip_encodes_as_the_image(wan):
    """A causal conv over one frame meets only its kernel's last temporal
    slice, and nothing is downsampled in time: in both packages a one-frame
    clip's latents are the image's."""
    jax_params, port_params = wan
    cfg = port_wan.TINY_WAN_VAE
    px = np.random.default_rng(4).uniform(-1, 1, size=(2, 16, 24, 3)).astype(np.float32)
    image = port_wan.encode_image(port_params, torch.from_numpy(px), cfg=cfg)
    _close(port_wan.encode_video(port_params, torch.from_numpy(px[:, None]), cfg=cfg)[:, 0],
           image, rel=1e-5)
    want = _jit(jax_wan.encode_image)(jax_params, jnp.asarray(px))
    _close(np.asarray(_jit(jax_wan.encode_video)(jax_params, jnp.asarray(px[:, None])))[:, 0],
           want, rel=1e-5)
    _close(image, want)


def test_clip_loader_matches_jax(tmp_path):
    """``load_clip_for_bucket`` on a 3-frame animated WEBP asked for 5
    frames (it loops: frames 3 and 4 are 0 and 1) and on a still, equal to
    JAX's; ``clip_frame_count`` rounds down to 1 + 4k as JAX's does."""
    rng = np.random.default_rng(0)
    frames = [Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8))
              for _ in range(3)]
    webp = tmp_path / "clip.webp"
    frames[0].save(webp, save_all=True, append_images=frames[1:], lossless=True)
    frames[0].save(tmp_path / "still.png")
    for path in (webp, tmp_path / "still.png"):
        meta = {"ip": path, "target_resolution": (16, 16)}
        got = port_prep.load_clip_for_bucket(meta, 5)
        np.testing.assert_array_equal(got, jax_prep.load_clip_for_bucket(meta, 5))
        assert got.shape == (5, 16, 16, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got[3], got[0])
        np.testing.assert_array_equal(got[4], got[1 if path == webp else 0])
    assert not np.array_equal(got[0], port_prep.load_clip_for_bucket(
        {"ip": webp, "target_resolution": (16, 16)}, 5)[1])
    assert [port_prep.clip_frame_count(n) for n in range(1, 18)] == \
        [jax_prep.clip_frame_count(n) for n in range(1, 18)]


# --------------------------------------------------------------------------
# The DiT at two latent frames, the preview sampler
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dit_params():
    return numpy_params(DIT, np.random.default_rng(23))


def _dit_inputs(rng, batch, frames):
    return (rng.normal(size=(batch, frames, 6, 8, DIT.in_channels)).astype(np.float32),
            rng.normal(size=(batch, LS, DIT.adapter_source_dim)).astype(np.float32),
            rng.integers(1, DIT.adapter_vocab, size=(batch, LS)).astype(np.int32))


def test_dit_forward_and_gradients_at_two_frames_match_jax(dit_params):
    """TINY DiT on (2, T'=2, 6, 8, C) latents: 3D RoPE over two frames,
    patchify and unpatchify at T > 1, the per-frame time embedding; the
    output and d sum(out * tangent) / d params against jax.grad."""
    rng = np.random.default_rng(24)
    latents, ctx, ids = _dit_inputs(rng, 2, 2)
    t = np.asarray([0.2, 0.9], np.float32)
    tangent = rng.normal(size=latents.shape[:-1] + (DIT.out_channels,)).astype(np.float32)

    def jax_loss(p):
        out = jax_dit.dit_forward(p, jnp.asarray(latents), jnp.asarray(t), jnp.asarray(ctx),
                                  cfg=DIT, t5_ids=jnp.asarray(ids), attn_impl="xla",
                                  compute_dtype=jnp.float32, remat=False)
        return jnp.sum(out * tangent), out

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in dit_params.items()})
    params = port_dit.params_from_jax(dit_params)
    for p in params.values():
        p.requires_grad_(True)
    out = port_dit.dit_forward(params, torch.from_numpy(latents), torch.from_numpy(t),
                               torch.from_numpy(ctx), cfg=PORT_DIT,
                               t5_ids=torch.from_numpy(ids), attn_impl="xla",
                               compute_dtype=torch.float32, remat=True)
    (out * torch.from_numpy(tangent)).sum().backward()
    assert out.shape == tangent.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    want_grads = {k: v.numpy() for k, v in port_dit.params_from_jax(
        {k: np.asarray(g) for k, g in grads.items()}).items()}
    assert _worst({k: p.grad.numpy() for k, p in params.items()}, want_grads) < 1e-4


@pytest.mark.parametrize("frames", [1, 2])
def test_preview_sampler_matches_jax(dit_params, frames):
    """Three Euler steps from the same noise, one image's or a clip's latent
    frames, in fp32."""
    rng = np.random.default_rng(30 + frames)
    noise, ctx, ids = _dit_inputs(rng, 1, frames)
    want = jax.jit(jax_sampler.make_anima_preview_sampler(
        DIT, 3, attn_impl="xla", compute_dtype=jnp.float32))(
        {k: jnp.asarray(v) for k, v in dit_params.items()}, jnp.asarray(noise),
        jnp.asarray(ctx), jnp.asarray(ids))
    got = port_sampler.make_anima_preview_sampler(
        PORT_DIT, 3, attn_impl="xla", compute_dtype=torch.float32)(
        port_dit.params_from_jax(dit_params), torch.from_numpy(noise),
        torch.from_numpy(ctx), torch.from_numpy(ids))
    _close(got, want, rel=2e-4)


@pytest.mark.parametrize("shape", [(1, 2, 5, 6, 4), (2, 5, 6, 4), (1, 1, 5, 6, 1)])
def test_latents_to_rgb_matches_jax(shape):
    lat = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = jax_sampler.latents_to_rgb(lat)
    np.testing.assert_allclose(port_sampler.latents_to_rgb(torch.from_numpy(lat)), want,
                               rtol=0, atol=1e-6)
    assert want.shape == (40, 48, 3)


def test_preview_renderer_outputs_and_failure(dit_params, wan, tmp_path, capsys):
    """The port's renderer on a TINY DiT and decoder: a clip through the
    decoder with ``time_conv`` is a filmstrip of its 5 frames; through a
    decoder without it, its first frame; with no decoder, latent-RGB; a
    decode that raises disables previews with a WARNING."""
    _, port_params = wan
    cfg = port_wan.TINY_WAN_VAE
    decoder = {k: v for k, v in port_params.items() if k.startswith(("decoder.", "conv2."))}
    image_decoder = {k: v for k, v in decoder.items() if ".time_conv." not in k}
    config = RuntimeConfig({"TRAINING_MODE": "Anima DiT", "SEED": 3,
                            "ANIMA_PREVIEW_EVERY_N_STEPS": 1,
                            "ANIMA_PREVIEW_SAMPLE_STEPS": 2}, validate_resume_paths=False)
    params = port_dit.params_from_jax(dit_params)
    latents, ctx, ids = (torch.from_numpy(x) for x in _dit_inputs(np.random.default_rng(5), 1, 2))
    for step, (dec, name, size) in enumerate((
            ((decoder, cfg), "step_1.png", (5 * 64, 48)),
            ((image_decoder, cfg), "step_2.png", (64, 48)),
            (None, "step_3_latent.png", (64, 48))), start=1):
        renderer = port_sampler.AnimaPreviewRenderer(
            config, PORT_DIT, attn_impl="xla", compute_dtype=torch.float32,
            decoder=dec)
        renderer.capture_conditioning(latents, ctx, ids)
        renderer.maybe_render(step, params, tmp_path)
        with Image.open(tmp_path / "previews" / name) as im:
            assert im.size == size and im.mode == "RGB"
    renderer._decode_video = mock.Mock(side_effect=RuntimeError("boom"))
    renderer.maybe_render(4, params, tmp_path)
    out = capsys.readouterr().out
    assert out.count("INFO: preview image saved") == 3
    assert "WARNING: preview sampling disabled after failure: RuntimeError: boom" in out
    assert not renderer.enabled


# --------------------------------------------------------------------------
# The plan of a video config
# --------------------------------------------------------------------------

class _Planned(Exception):
    pass


def _stop_after_plan(module, record: list):
    real = module.plan_anima_training

    def plan(**kwargs):
        record.append((kwargs, real(**kwargs)))
        raise _Planned

    return mock.patch.object(module, "plan_anima_training", plan)


def test_video_plan_matches_jax(tmp_path, monkeypatch):
    """Both trainers, run up to their memory plan on one cache of 64 px
    items with ``ANIMA_VIDEO_FRAMES`` 9: the plan counts three latent
    frames of 4 x 4 patches (48 tokens), and the plans are equal."""
    monkeypatch.setenv("AOZORA_DEVICES", "1")
    _build_env(tmp_path)
    flat = _trainer_flat(tmp_path, "out", ANIMA_VIDEO_FRAMES=9)
    jax_plans, port_plans = [], []
    with mock.patch("aozora_sdxl_training_tpu.train.anima_trainer."
                    "check_if_anima_caching_needed", return_value=False), \
            mock.patch.object(port_trainer, "check_if_anima_caching_needed",
                              return_value=False), \
            _stop_after_plan(jax_mp, jax_plans), \
            _stop_after_plan(port_trainer.memory_policy, port_plans), \
            contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(_Planned):
            run_anima_training(JaxConfig(flat, validate_resume_paths=False))
        with pytest.raises(_Planned):
            port_trainer.run_anima_training(RuntimeConfig(flat, validate_resume_paths=False),
                                            device="cpu")
    ((jax_kw, jax_plan),), ((port_kw, port_plan),) = jax_plans, port_plans
    assert jax_kw["tokens"] == port_kw["tokens"] == 3 * (64 // 8 // 2) ** 2
    assert {k: v for k, v in jax_kw.items() if k not in ("requested_moment_dtype",
                                                         "budget_bytes")} == \
        {k: v for k, v in port_kw.items() if k not in ("requested_moment_dtype",
                                                       "budget_bytes")}
    _same(jax_plan, port_plan)


# --------------------------------------------------------------------------
# A TINY video run through the port's CLIs, and the clips cache of each
# package
# --------------------------------------------------------------------------

VIDEO_RUN = """
import sys
import torch
torch.set_num_threads(1)   # as one_thread() does in-process
from aozora_sdxl_training_tpu_torch.cli import cache_datasets, train_anima
preset = sys.argv[1]
cache_datasets.main(["--config", preset])
print("=== training ===")
train_anima.main(["--config", preset])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.split(".")[0] == "aozora_sdxl_training_tpu")
print("JAX MODULES", bad)
"""


@pytest.fixture(scope="module")
def video_run(tmp_path_factory):
    """TINY Qwen3, a full TINY Wan file and DiT, two 5-frame 32 px clips
    (animated WEBP; they land in the 640 x 640 bucket); the port's cache
    CLI then its Anima CLI, ``ANIMA_VIDEO_FRAMES`` 5 (T' = 2 latent
    frames), 2 micro steps at GA 2, a 2-step preview every optimizer step,
    in a fresh interpreter. Returns (root, the preset's flat config,
    stdout)."""
    root = tmp_path_factory.mktemp("anima_video")
    q_cfg = port_qwen3.TINY_QWEN3
    write_random_qwen3_checkpoint(root / "qwen.safetensors", q_cfg, seed=5)
    write_random_wan_vae_checkpoint(root / "vae.safetensors", port_wan.TINY_WAN_VAE,
                                    seed=6, decoder=True)
    write_random_dit_checkpoint(
        root / "dit.safetensors",
        replace(port_dit.TINY_ANIMA, in_channels=V_CFG.z_dim, out_channels=V_CFG.z_dim,
                adapter_source_dim=q_cfg.hidden_size), seed=8)
    write_clip_dataset(root / "data", n_clips=2, frames=5, image_size=(32, 32), seed=9)
    flat = {"TRAINING_MODE": "Anima DiT", "DIT_PATH": str(root / "dit.safetensors"),
            "TEXT_ENCODER_PATH": str(root / "qwen.safetensors"),
            "DIT_VAE_PATH": str(root / "vae.safetensors"),
            "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}],
            "MAX_BUCKET_RESOLUTION": 640, "ANIMA_VIDEO_FRAMES": 5,
            "OUTPUT_DIR": str(root / "out"), "OUTPUT_NAME": "video", "MAX_TRAIN_STEPS": 2,
            "BATCH_SIZE": 1, "GRADIENT_ACCUMULATION_STEPS": 2, "SAVE_EVERY_N_STEPS": 0,
            "SEED": 3, "MIXED_PRECISION": "bfloat16", "ANIMA_PREVIEW_EVERY_N_STEPS": 1,
            "ANIMA_PREVIEW_SAMPLE_STEPS": 2}
    preset = root / "preset.json"
    preset.write_text(json.dumps(schema.nest_flat_config(flat, "anima")))
    res = subprocess.run(
        [sys.executable, "-c", VIDEO_RUN, str(preset)], cwd=root, capture_output=True,
        text=True, timeout=300,
        env={**__import__("os").environ, "AOZORA_PLATFORM": "cpu",
             "PYTHONPATH": str(REPO), "AOZORA_DEVICES": "1"})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    # the config as the CLIs read the preset (its VAE path names the
    # cache's VAE source)
    return root, schema.flatten_preset(json.loads(preset.read_text())), res.stdout


def test_video_run_through_the_port_clis(video_run):
    """The cache holds (2, 80, 80, z) clip latents; training runs on them
    with finite losses; the preview is a decoded filmstrip of the sampled
    clip's 5 frames; the DiT is saved; no JAX module was imported."""
    root, flat, out = video_run
    cache, training = out.split("=== training ===")
    assert "phase 1/2: encoding 2 captions" in cache
    assert "phase 2/2: encoding 2 latents" in cache
    assert "encoding" not in training and "JAX MODULES []" in training
    assert "INFO: preview sampling (decoded pixels) every 1 optimizer step(s)" in training
    assert "preview sampling disabled" not in training
    losses = [float(m.group(3)) for m in map(ANIMA_PROGRESS.search, _gui_lines(training)) if m]
    assert len(losses) >= 2 and all(map(math.isfinite, losses))
    lat = port_cache.cs.load_payload(port_cache.cs.lat_path_for(
        root / "data" / ".precomputed_anima_dit_cache", "clip0"))[0]["latents"]
    assert lat.shape == (2, 80, 80, V_CFG.z_dim) and lat.dtype.name == "bfloat16"
    with Image.open(root / "out" / "previews" / "step_1.png") as im:
        assert im.size == (5 * 640, 640) and im.mode == "RGB"
    assert (root / "out" / "video.safetensors").exists()


def test_video_run_stdout_matches_gui_grammar(video_run):
    """The video run's stdout (the cache pass, the plan, the preview lines)
    through every GUI channel: progress with Ticket and Sigma, the
    optimizer block, grad norms, the parameter-info line and the cache
    signal; no error keyword; no line parses as SDXL progress."""
    _, _, out = video_run
    lines = _gui_lines(out)
    hits = _audit(lines, ANIMA_PROGRESS, expect_sigma=True)
    assert hits["progress"] >= 2, hits
    assert hits["optim"] >= 1 and hits["grad"] >= 1, hits
    assert hits["param_info"] == 1 and hits["cache"] >= 1, hits
    assert hits["error"] == 0, hits
    assert all(not SDXL_PROGRESS.search(line) for line in lines)


def test_clips_caches_built_by_each_package_agree(video_run):
    """The JAX package's cache of the same two clips, with its real TINY
    encoders: each package's check accepts the other's cache, and the
    payloads agree (keys, dtypes, shapes, metadata, T5 ids; bf16 values
    within the tolerance)."""
    root, flat, _ = video_run
    port_cfg, jax_cfg = _configs(flat)
    cache_dir = root / "data" / port_cache.anima_cache_dir_name(port_cfg)
    got = _snapshot(cache_dir)
    assert jax_cache.check_if_anima_caching_needed(jax_cfg) is False
    port_copy = root / "port_cache"
    shutil.move(cache_dir, port_copy)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jax_cache.precompute_and_cache_anima(jax_cfg, force=True)
        assert port_cache.check_if_anima_caching_needed(port_cfg) is False
        want = _snapshot(cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        shutil.move(port_copy, cache_dir)
    assert got.keys() == want.keys() and got["index"] == want["index"]
    assert len(got) == 5        # the index and two te and two latent payloads
    for name in sorted(set(want) - {"index"}):
        (gt, gm), (wt, wm) = got[name], want[name]
        assert gm == wm and gt.keys() == wt.keys(), name
        assert gm["cache_options"]["video_frames"] == 5
        for key, w in wt.items():
            g = gt[key]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (name, key)
            if key == "t5xxl_ids":
                np.testing.assert_array_equal(g, w, err_msg=name)
                continue
            g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * np.abs(w).max(),
                                       err_msg=f"{name}:{key}")
