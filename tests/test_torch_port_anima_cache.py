"""PyTorch port: the Anima caching path against the JAX package.

Same numpy weights (the JAX layout carried over with ``params_from_jax``,
or one torch-layout file read by both packages' loaders) and the same
numpy inputs go through both packages on the CPU at TINY sizes:

* the Qwen3 text encoder, with padding, and with token ids at and above
  its vocabulary (the hash tokenizer's ids run to 49407; TINY_QWEN3 has
  256 rows), forward and the embedding's gradient;
* the Wan VAE encoder: ``encode_image`` through 5-D causal kernels, and
  ``encode_image_tiled`` over ragged tiles;
* caches built by each package with its real TINY encoders, in txt and
  json caption modes with the null embeds, and each package's check
  accepting the other's cache;
* the first run: images -> the port's cache CLI -> the port's Anima CLI,
  in a fresh interpreter that never imports JAX.

Tolerances, each with its reason:

* modules: 1e-4 of the output's largest magnitude: the same fp32 function
  computed by XLA and by PyTorch's CPU kernels, which sum in other orders;
* caches: 2e-2 of the payload's largest magnitude, since both store bf16
  and a value near a rounding boundary can land one bf16 step (2^-8
  relative) apart; T5 ids, keys, dtypes, shapes and metadata are equal.
"""

import json
import shutil
import subprocess
import sys
from dataclasses import asdict, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.ckpt import anima_checkpoint as jax_ckpt
from aozora_sdxl_training_tpu.data import anima_cache as jax_cache
from aozora_sdxl_training_tpu.models.anima import qwen3 as jax_qwen3
from aozora_sdxl_training_tpu.models.anima import wan_vae as jax_wan
from aozora_sdxl_training_tpu_torch.ckpt import anima_checkpoint as port_ckpt
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.data import anima_cache as port_cache
from aozora_sdxl_training_tpu_torch.data.synthetic import (
    write_image_dataset, write_random_dit_checkpoint, write_random_qwen3_checkpoint,
    write_random_wan_vae_checkpoint)
from aozora_sdxl_training_tpu_torch.data.tokenization import HashTokenizer
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.models.anima import qwen3 as port_qwen3
from aozora_sdxl_training_tpu_torch.models.anima import wan_vae as port_wan

from tests.test_torch_port_cache_preview import _configs, _snapshot
from tests.test_torch_port_trainer import one_thread

REPO = Path(__file__).resolve().parents[1]
Q_CFG = jax_qwen3.TINY_QWEN3
V_CFG = jax_wan.TINY_WAN_VAE


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


def _close(got, want, rel=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# --------------------------------------------------------------------------
# Qwen3
# --------------------------------------------------------------------------

def _qwen_numpy_params(rng):
    """JAX-layout params, N(0, 1/fan_in) matrices and perturbed unit scales."""
    out = {}
    for name, shape in sorted(jax_qwen3.param_shapes(Q_CFG).items()):
        if len(shape) == 1:
            out[name] = (1.0 + rng.normal(scale=0.1, size=shape)).astype(np.float32)
        else:
            out[name] = (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
    return out


@pytest.mark.parametrize("case", ["padding", "ids_past_the_vocabulary"])
def test_qwen3_forward_and_embedding_gradient_match_jax(case):
    """Two captions of 12 tokens: one padded after 5 tokens under the
    attention mask (padded query rows still see the valid prefix); or ids
    at and above the 256-row vocabulary (the hash tokenizer's BOS 49406 and
    EOS 49407 among them), which both packages read as the last row. The
    output, and the gradient of <output, t> with respect to the embedding
    table, to which such an id adds nothing (JAX's scatter-add drops an
    out-of-range update)."""
    rng = np.random.default_rng(3)
    np_params = _qwen_numpy_params(rng)
    ids = rng.integers(1, Q_CFG.vocab_size, size=(2, 12)).astype(np.int32)
    mask = None
    if case == "padding":
        mask = np.ones((2, 12), np.int32)
        mask[1, 5:] = 0
        ids[1, 5:] = 0
    else:
        tok = HashTokenizer()
        ids[0, [0, 11]] = tok.bos_token_id, tok.eos_token_id
        ids[1, [2, 3, 7]] = Q_CFG.vocab_size, Q_CFG.vocab_size + 44, 49000
    tangent = rng.normal(size=(2, 12, Q_CFG.hidden_size)).astype(np.float32)

    def jax_loss(embed):
        params = {**{k: jnp.asarray(v) for k, v in np_params.items()},
                  "model.embed_tokens.weight": embed}
        out = jax_qwen3.qwen3_forward(params, jnp.asarray(ids),
                                      None if mask is None else jnp.asarray(mask), Q_CFG)
        return jnp.sum(out * tangent), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(np_params["model.embed_tokens.weight"]))
    params = port_qwen3.params_from_jax(np_params)
    embed = params["model.embed_tokens.weight"].requires_grad_(True)
    got = port_qwen3.qwen3_forward(params, torch.from_numpy(ids),
                                   None if mask is None else torch.from_numpy(mask),
                                   port_qwen3.TINY_QWEN3)
    (got * torch.from_numpy(tangent)).sum().backward()
    _close(got, want)
    _close(embed.grad, want_grad)


def test_qwen3_torch_state_loads_alike_in_both_packages(tmp_path):
    """One random bf16 Qwen3 file under a ``text_encoder.`` prefix with an
    ``lm_head``: both loaders strip and drop the same keys, both read the
    same config off its shapes (rope theta 1e6, read from nowhere), and
    both encoders give the same output."""
    path = tmp_path / "te.safetensors"
    write_random_qwen3_checkpoint(tmp_path / "plain.safetensors",
                                  port_qwen3.TINY_QWEN3, seed=2)
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all, write_streaming
    plain = load_all(tmp_path / "plain.safetensors")
    write_streaming(path, {**{f"text_encoder.{k}": v for k, v in plain.items()},
                           "text_encoder.lm_head.weight": plain["model.embed_tokens.weight"]})
    port_state = port_ckpt.load_text_encoder_state(path)
    jax_state = jax_ckpt.load_text_encoder_state(path)
    assert port_state.keys() == jax_state.keys() == plain.keys()
    port_cfg = port_qwen3.detect_config(port_state)
    jax_cfg = jax_qwen3.detect_config(jax_state)
    assert asdict(port_cfg) == asdict(jax_cfg)
    assert port_cfg == replace(port_qwen3.TINY_QWEN3, rope_theta=1e6)
    ids = np.random.default_rng(4).integers(0, 49408, size=(2, 9)).astype(np.int32)
    want = jax.jit(lambda p, x: jax_qwen3.qwen3_forward(p, x, None, jax_cfg))(
        jax_qwen3.params_from_torch_state(jax_state, jax_cfg), jnp.asarray(ids))
    got = port_qwen3.qwen3_forward(port_qwen3.params_from_torch_state(port_state, port_cfg),
                                   torch.from_numpy(ids), None, port_cfg)
    _close(got, want)


# --------------------------------------------------------------------------
# Wan VAE
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_numpy_params():
    """JAX-layout params with random biases and gammas; the 3x3 causal convs
    as full (kt=3) kernels whose first two temporal slices are random, so
    that a port reading the wrong slice shows."""
    rng = np.random.default_rng(7)
    out = {}
    for name, shape in sorted(jax_wan.param_shapes(V_CFG).items()):
        if name.endswith(".bias"):
            out[name] = rng.normal(scale=0.05, size=shape).astype(np.float32)
        elif name.endswith(".gamma"):
            out[name] = (1.0 + rng.normal(scale=0.1, size=shape)).astype(np.float32)
        else:
            w = (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
            if shape[0] == 3 and ".resample." not in name:
                w = np.stack([rng.normal(size=shape).astype(np.float32),
                              rng.normal(size=shape).astype(np.float32), w])
            out[name] = w
    return out


def test_wan_vae_encode_image_matches_jax(vae_numpy_params):
    """Two 40 x 48 images (odd sizes after the second downsample)."""
    px = np.random.default_rng(8).uniform(-1, 1, size=(2, 40, 48, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_wan.encode_image(p, x, cfg=V_CFG))(
        vae_numpy_params, jnp.asarray(px))
    got = port_wan.encode_image(port_wan.params_from_jax(vae_numpy_params),
                                torch.from_numpy(px), cfg=port_wan.TINY_WAN_VAE)
    assert got.shape == (2, 5, 6, V_CFG.z_dim)
    _close(got, want)


def test_wan_vae_encode_image_tiled_matches_jax(vae_numpy_params):
    """56 x 40 px at tile 4, stride 3 (latent units): 2 x 2 overlapping
    tiles of 32 px rows, the right ones ragged (16 px), blended on the
    host."""
    px = np.random.default_rng(9).uniform(-1, 1, size=(1, 56, 40, 3)).astype(np.float32)
    assert port_wan.tile_tasks(56, 40, 32, 32, 24, 24) == [
        (0, 32, 0, 32), (0, 32, 24, 56), (24, 56, 0, 32), (24, 56, 24, 56)]
    encode = jax.jit(lambda p, x: jax_wan.encode_image(p, x, cfg=V_CFG))
    want = jax_wan.encode_image_tiled(
        vae_numpy_params, px, cfg=V_CFG, tile_size=(4, 4), tile_stride=(3, 3),
        encode_fn=lambda tile: encode(vae_numpy_params, tile))
    got = port_wan.encode_image_tiled(port_wan.params_from_jax(vae_numpy_params), px,
                                      cfg=port_wan.TINY_WAN_VAE, tile_size=(4, 4),
                                      tile_stride=(3, 3))
    assert got.shape == (1, 7, 5, V_CFG.z_dim)
    _close(got, want)


def test_wan_vae_torch_state_loads_alike_in_both_packages(tmp_path):
    """One random bf16 Wan file in the torch layout (5-D causal kernels,
    ``time_conv``, gammas with broadcast dims) under a ``vae.`` prefix:
    both loaders give the same tensors and config, and both encoders the
    same latents."""
    write_random_wan_vae_checkpoint(tmp_path / "plain.safetensors",
                                    port_wan.TINY_WAN_VAE, seed=3)
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all, write_streaming
    plain = load_all(tmp_path / "plain.safetensors")
    assert plain["encoder.conv1.weight"].shape == (8, 3, 3, 3, 3)
    assert plain["encoder.downsamples.5.time_conv.weight"].shape == (16, 16, 3, 1, 1)
    write_streaming(tmp_path / "vae.safetensors", {f"vae.{k}": v for k, v in plain.items()})
    port_params = port_wan.params_from_torch_state(
        port_ckpt.load_vae_state(tmp_path / "vae.safetensors"))
    jax_params = jax_wan.params_from_torch_state(
        jax_ckpt.load_vae_state(tmp_path / "vae.safetensors"))
    assert port_params.keys() == jax_params.keys()
    assert asdict(port_wan.detect_config(port_params)) == \
        asdict(jax_wan.detect_config(jax_params))
    px = np.random.default_rng(10).uniform(-1, 1, size=(1, 32, 24, 3)).astype(np.float32)
    _close(port_wan.encode_image(port_params, torch.from_numpy(px), cfg=port_wan.TINY_WAN_VAE),
           jax.jit(lambda p, x: jax_wan.encode_image(p, x, cfg=V_CFG))(
               jax_params, jnp.asarray(px)))


# --------------------------------------------------------------------------
# Caches built by each package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder_files(tmp_path_factory):
    """TINY Qwen3 (256-row vocabulary, below the hash tokenizer's ids) and
    TINY Wan VAE files, and two captioned 64 x 64 images (the 640 x 640
    bucket)."""
    root = tmp_path_factory.mktemp("anima_cache")
    write_random_qwen3_checkpoint(root / "qwen.safetensors", port_qwen3.TINY_QWEN3, seed=5)
    write_random_wan_vae_checkpoint(root / "vae.safetensors", port_wan.TINY_WAN_VAE, seed=6)
    write_image_dataset(root / "data", n_images=2, image_size=(64, 64), seed=7)
    return root


def _flat(root: Path, data: Path, **overrides) -> dict:
    return {"TRAINING_MODE": "Anima DiT",
            "DIT_PATH": str(root / "dit.safetensors"),
            "TEXT_ENCODER_PATH": str(root / "qwen.safetensors"),
            "DIT_VAE_PATH": str(root / "vae.safetensors"),
            "INSTANCE_DATASETS": [{"path": str(data), "repeats": 1}],
            "MAX_BUCKET_RESOLUTION": 640, **overrides}


@pytest.mark.parametrize("mode", ["txt", "json"])
def test_caches_built_by_each_package_agree(encoder_files, tmp_path, mode):
    """Both packages' ``precompute_and_cache_anima`` with their real TINY
    encoders from ``from_config`` (tiled VAE, one ragged tile over each
    640 px image) on the same images: the same payload files (with the
    null embeds), keys, dtypes, shapes and metadata, bf16 values within the
    tolerance, identical T5 ids, and each package's check accepts the
    other's cache."""
    data = tmp_path / "data"
    shutil.copytree(encoder_files / "data", data, copy_function=shutil.copy2)
    overrides = {"QWEN_NULL_DROPOUT_CHANCE": 0.1}
    if mode == "json":
        overrides = {"CAPTION_SOURCE_TYPE": "json", "UNCONDITIONAL_DROPOUT": True}
        for i, img in enumerate(sorted(data.glob("*.png"))):
            img.with_suffix(".json").write_text(json.dumps(
                {"tags": f"tag{i}, red, blue", "nl": f"a picture number {i}",
                 "tags_nl": f"tag{i}. a picture", "nl_tags": f"picture {i}, tag{i}"}))
    port_cfg, jax_cfg = _configs(_flat(encoder_files, data, **overrides))
    cache_dir = data / port_cache.anima_cache_dir_name(port_cfg)

    jax_cache.precompute_and_cache_anima(jax_cfg, force=True)
    assert port_cache.check_if_anima_caching_needed(port_cfg) is False
    want = _snapshot(cache_dir)
    shutil.rmtree(cache_dir)
    port_cache.precompute_and_cache_anima(port_cfg, force=True, device="cpu")
    assert jax_cache.check_if_anima_caching_needed(jax_cfg) is False
    got = _snapshot(cache_dir)

    assert got.keys() == want.keys() and got["index"] == want["index"]
    assert "null_embeds.safetensors" in got
    assert len(got) - 2 == (10 if mode == "json" else 4)  # te and latent payloads
    for name in sorted(set(want) - {"index"}):
        (gt, gm), (wt, wm) = got[name], want[name]
        assert gm == wm and gt.keys() == wt.keys(), name
        for key, w in wt.items():
            g = gt[key]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (name, key)
            if key == "t5xxl_ids":
                np.testing.assert_array_equal(g, w, err_msg=name)
                continue
            g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * np.abs(w).max(),
                                       err_msg=f"{name}:{key}")
    te = got[Path(got["index"]["files"][0]["te_path"]).name][0]
    assert te["prompt_emb"].shape == (512, Q_CFG.hidden_size)
    assert te["prompt_emb"].dtype.name == "bfloat16" and te["t5xxl_ids"].dtype == np.int32
    assert te["t5xxl_ids"].max() > Q_CFG.vocab_size          # hash ids past the vocab
    assert got["img0_lat.safetensors"][0]["latents"].shape == (80, 80, V_CFG.z_dim)


# --------------------------------------------------------------------------
# The first run through the port's CLIs
# --------------------------------------------------------------------------

FIRST_RUN = """
import sys
import torch
torch.set_num_threads(1)   # as one_thread() does in-process
from aozora_sdxl_training_tpu_torch.cli import cache_datasets, train_anima
preset = sys.argv[1]
cache_datasets.main(["--config", preset])
print("=== second cache run ===")
cache_datasets.main(["--config", preset])
print("=== training ===")
train_anima.main(["--config", preset])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.split(".")[0] == "aozora_sdxl_training_tpu")
print("JAX MODULES", bad)
"""


def test_first_anima_run_through_the_port_clis(encoder_files, tmp_path):
    """images -> the port's cache_datasets CLI (Anima mode) -> the port's
    train_anima CLI for 2 steps, on the CPU, in a fresh interpreter that
    imports no JAX: the cache is built once (a second run encodes nothing)
    and training runs on it, with a TINY DiT whose 128-row T5 vocabulary is
    below the hash tokenizer's ids, so every batch holds ids it clamps."""
    root = tmp_path
    shutil.copytree(encoder_files / "data", root / "data", copy_function=shutil.copy2)
    for name in ("qwen.safetensors", "vae.safetensors"):
        shutil.copy2(encoder_files / name, root / name)
    dit_cfg = replace(port_dit.TINY_ANIMA, in_channels=V_CFG.z_dim,
                      out_channels=V_CFG.z_dim, adapter_source_dim=Q_CFG.hidden_size)
    assert dit_cfg.adapter_vocab == 128
    write_random_dit_checkpoint(root / "dit.safetensors", dit_cfg, seed=8)
    flat = _flat(root, root / "data", OUTPUT_DIR=str(root / "out"),
                 OUTPUT_NAME="first", MAX_TRAIN_STEPS=2, BATCH_SIZE=1,
                 GRADIENT_ACCUMULATION_STEPS=1, SAVE_EVERY_N_STEPS=0, SEED=3,
                 MIXED_PRECISION="bfloat16")
    preset = root / "preset.json"
    preset.write_text(json.dumps(schema.nest_flat_config(flat, "anima")))
    res = subprocess.run(
        [sys.executable, "-c", FIRST_RUN, str(preset)], cwd=root, capture_output=True,
        text=True, timeout=300,
        env={**__import__("os").environ, "AOZORA_PLATFORM": "cpu",
             "PYTHONPATH": str(REPO), "AOZORA_DEVICES": "1"})
    out = res.stdout
    assert res.returncode == 0, out[-3000:] + res.stderr[-3000:]
    first, rest = out.split("=== second cache run ===")
    second, training = rest.split("=== training ===")
    assert "phase 1/2: encoding 2 captions" in first
    assert "phase 2/2: encoding 2 latents" in first
    assert port_cache.cache_complete_message(2, root / "data" /
                                             ".precomputed_anima_dit_cache") in first
    assert "encoding" not in second and "already cached" in second
    assert "encoding" not in training and training.count("Loss:") >= 2
    assert "JAX MODULES []" in training
    assert (root / "out" / "first.safetensors").exists()
    ids = port_cache.cs.load_payload(port_cache.cs.te_path_for(
        root / "data" / ".precomputed_anima_dit_cache", "img0"))[0]
    assert ids["t5xxl_ids"].max() >= dit_cfg.adapter_vocab


def test_pipeline_loads_the_components_like_jax(encoder_files, tmp_path):
    """``AnimaTrainingComponents.from_pretrained`` of both packages on one
    DiT, Qwen3 and VAE file: the same DiT and text-encoder configs, key
    prefix, parameter names and tokenizers; ``preprocess_image`` gives the
    same pixels."""
    from PIL import Image
    from aozora_sdxl_training_tpu.models.anima.pipeline import (
        AnimaTrainingComponents as JaxComponents)
    from aozora_sdxl_training_tpu_torch.models.anima.pipeline import (
        AnimaTrainingComponents as PortComponents)
    dit_cfg = replace(port_dit.TINY_ANIMA, adapter_source_dim=Q_CFG.hidden_size)
    write_random_dit_checkpoint(tmp_path / "dit.safetensors", dit_cfg, seed=9)
    paths = {"dit_path": tmp_path / "dit.safetensors",
             "text_encoder_path": encoder_files / "qwen.safetensors",
             "vae_path": encoder_files / "vae.safetensors"}
    port = PortComponents.from_pretrained(**paths, device="cpu")
    ref = JaxComponents.from_pretrained(**paths)
    assert port.dit_prefix == ref.dit_prefix == "pipe.dit."
    assert asdict(port.dit_config) == asdict(ref.dit_config)
    assert asdict(port.text_encoder_config) == asdict(ref.text_encoder_config)
    assert port.dit_params.keys() == ref.dit_params.keys()
    assert port.text_encoder_params.keys() == ref.text_encoder_params.keys()
    assert port.vae_params.keys() == ref.vae_params.keys()
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in port.vae_params.values())
    assert type(port.tokenizer).__name__ == type(ref.tokenizer_t5xxl).__name__ == "HashTokenizer"
    image = Image.open(sorted((encoder_files / "data").glob("*.png"))[0])
    np.testing.assert_array_equal(PortComponents.preprocess_image(image),
                                  JaxComponents.preprocess_image(image))
