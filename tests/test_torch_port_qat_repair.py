"""PyTorch port: the QAT repair path against the JAX package.

* ``train/qat_project.py``, the device projector, on the CPU: each format's
  projection against the numpy quantizers' round trip, bit for bit, and
  against JAX's ``qat_project_jax.project_weight``; the e2m1 ties; the
  numpy-order row sum; three steps of error feedback against JAX's
  projector, residuals equal in fp16;
* the line-art cache: the port's cache builder writes JAX's
  ``_lineart_mask_for`` mask (JAX's with cv2, the port's without) into
  image and clip payloads, and JAX's cache check and dataset read the
  port's cache;
* the slice as a whole: the port's repair CLI and JAX's on one TINY
  quantized checkpoint (int8 on ``mlp.layer1``, NVFP4 on the self-attention
  query) and one synthetic cache with line-art masks, for 2 optimizer
  steps, and the first step's line-art-masked micro step, its loss and
  every gradient (as each trainer hands them to the clip) against JAX's;
  then the port's bf16 control arm; the CLI's refusal under torchrun.

Tolerances, each with its reason:

* the projection: bit for bit against numpy in all five formats. Against
  JAX bit for bit in e4m3, e5m2 and NVFP4; int8 equal in value (JAX keeps
  the sign of a rounded -0.0, numpy's int8 codes do not); ternary at JAX's
  own bar against numpy, rtol 1e-6, since XLA sums the row mean in another
  order than numpy's pairwise sum, which the port follows;
* the masks: 1e-5 absolute on values in [0, 1] (the blurs' taps applied
  in another order move a float32 ulp; the percentile scaling scales it);
* the micro step in fp32: loss rtol 1e-5, gradients 1e-4 of each tensor's
  largest magnitude (XLA's fusions against eager kernels);
* the CLI runs compute in fp32 (the parsed config's compute dtype is set
  to fp32: in bf16, noise flips the sign of near-zero gradients, which
  Adam's first step turns into whole int8 steps): losses rtol 1e-5; at
  least 99.9% of each tensor's packed codes equal to JAX's and none more
  than one code apart (an effective weight an fp32 rounding from a code
  boundary may land on either side), while ~66% of the int8 and ~3% of
  the NVFP4 codes move from the input; the scales within 1e-4 relative
  (a row's absmax after two fp32 Adam steps summed in other orders).
"""

import contextlib
import io
import json
import re
from dataclasses import replace
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aozora_sdxl_training_tpu.train.reporter as jax_reporter
from aozora_sdxl_training_tpu.cli import train_anima_repair as jax_cli
from aozora_sdxl_training_tpu.config.runtime import RuntimeConfig as JaxConfig
from aozora_sdxl_training_tpu.data import anima_cache as jax_cache
from aozora_sdxl_training_tpu.opt import adamw as jax_adamw
from aozora_sdxl_training_tpu.train import qat_project_jax as jax_proj
from aozora_sdxl_training_tpu.train import objectives as jax_sdxl_obj
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all, write_streaming
from aozora_sdxl_training_tpu_torch.cli import train_anima_repair as port_cli
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
from aozora_sdxl_training_tpu_torch.data import anima_cache as port_cache
from aozora_sdxl_training_tpu_torch.data import cache_store as cs
from aozora_sdxl_training_tpu_torch.data.synthetic import write_clip_dataset, write_image_dataset
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.opt import adamw as port_adamw
import aozora_sdxl_training_tpu_torch.train.reporter as port_reporter
from aozora_sdxl_training_tpu_torch.tools import quantize as q
from aozora_sdxl_training_tpu_torch.train import anima_trainer as port_trainer
from aozora_sdxl_training_tpu_torch.train import objectives as port_sdxl_obj
from aozora_sdxl_training_tpu_torch.train import qat_project as port_proj
from aozora_sdxl_training_tpu_torch.train.qat_repair import ProjectedQuantController

from tests.test_torch_port_anima_dit import numpy_params
from tests.test_torch_port_anima_trainer import CFG as TINY_CFG, _recording
from tests.test_torch_port_trainer import one_thread

# one block and one adapter layer: the JAX trainer compiles in about half the time
CFG = replace(TINY_CFG, num_blocks=1, adapter_layers=1)
FORMATS = ("float8_e4m3fn", "float8_e5m2", "int8_tensorwise", "nvfp4", "ternary_1_58")
LAT, LS, LR = 8, 12, 3e-4


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


def _weight(rng, shape):
    """A weight with rows at very different scales, zero rows and -0.0
    entries, so that fp8 subnormals, zero scales and signed zeros occur."""
    w = (rng.normal(size=shape) * rng.uniform(0.01, 2.0)).astype(np.float32)
    w[::5] *= 1e-4
    w[1::7] = 0.0
    w[2, :3] = -0.0
    return w


def _host_round_trip(w, fmt):
    records = dict(q.quant_records_for_weight("w.weight", w, fmt))
    return np.asarray(q.dequantize_records("w.weight", records, out_shape=w.shape),
                      np.float32)


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


# --------------------------------------------------------------------------
# The device projector
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_projection_matches_numpy_and_jax(fmt):
    """Three shapes against numpy (a row past 8192 elements among them),
    the last against JAX, whose ops run one by one with a compile each."""
    rng = np.random.default_rng(7)
    for shape in ((130, 208), (16, 8208), (32, 48)):
        w = _weight(rng, shape)
        got = port_proj.project_weight(fmt, torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(_host_round_trip(w, fmt)),
                                      err_msg=f"{fmt} {shape} against numpy")
    want = np.asarray(jax_proj.project_weight(fmt, jnp.asarray(w)), np.float32)
    if fmt == "ternary_1_58":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    elif fmt == "int8_tensorwise":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=fmt)


def test_e2m1_rounding_matches_jax_and_the_codes():
    """Exact midpoints and endpoints, a fine grid and random magnitudes:
    the grid rounding equals JAX's and ``f32_to_e2m1_codes``' RNE."""
    xs = np.concatenate([
        np.asarray([0.0, 0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 6.0], np.float32),
        np.linspace(0, 6, 977, dtype=np.float32),
        np.random.default_rng(3).uniform(0, 6, 500).astype(np.float32)])
    got = port_proj._round_e2m1_magnitude(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_proj._round_e2m1_magnitude(xs)))
    np.testing.assert_array_equal(got, q.e2m1_to_f32(q.f32_to_e2m1_codes(xs)))


def test_numpy_row_sum_is_numpy_sum_bit_for_bit():
    """Every branch of numpy's pairwise sum (below 8, up to 128, halves of
    equal and of unequal length) and rows past 8192 elements, which numpy
    2.0 sums in 8192-element buffers and numpy 2.3 whole."""
    rng = np.random.default_rng(2)
    for n in (1, 7, 8, 9, 127, 128, 129, 136, 1000, 2048, 8192, 8193, 20000):
        a = np.abs(rng.normal(size=(3, n))).astype(np.float32)
        got = port_proj._numpy_row_sum(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(a.sum(axis=1)), err_msg=str(n))


def test_device_projector_matches_jax_over_three_steps():
    """Three updates, each followed by the projection: parameters and fp16
    residuals against JAX's projector (linear weights (in, out) there,
    transposed on the way in and out), one tensor per format, one with an
    NVFP4 scale multiplier. JAX's projector runs op by op: jitted, XLA's CPU fusion rounds the fp8 round trip otherwise
    and parts from the numpy quantizers themselves."""
    rng = np.random.default_rng(11)
    formats = {f"blocks.{i}.w.weight": fmt for i, fmt in enumerate(FORMATS)}
    params = {k: _weight(rng, (32, 48)) for k in formats}
    init, project = port_proj.make_device_projector(formats, {"blocks.3.w.weight": 0.8})
    jinit, jproject = jax_proj.make_device_projector(formats, {"blocks.3.w.weight": 0.8})

    port = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jax_params = {k: jnp.asarray(v.T) for k, v in params.items()}
    res, jres = init(port), jinit(jax_params)
    assert all(r.dtype == torch.float16 and r.shape == port[k].shape for k, r in res.items())
    for step in range(3):
        update = {k: (rng.normal(size=v.shape) * 0.02).astype(np.float32)
                  for k, v in params.items()}
        for k in port:
            port[k] += torch.from_numpy(update[k])
        jax_params = {k: v + jnp.asarray(update[k].T) for k, v in jax_params.items()}
        project(port, res)
        jax_params, jres = jproject(jax_params, jres)
        for k, fmt in formats.items():
            want_p = np.asarray(jax_params[k]).T
            want_r = np.asarray(jres[k]).astype(np.float32)
            got_p, got_r = port[k].numpy(), res[k].float().numpy()
            if fmt == "ternary_1_58":
                np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=0, err_msg=k)
                # a scale an ulp apart moves a residual one fp16 step, and
                # the feedback carries it into the next steps
                np.testing.assert_allclose(got_r, want_r, rtol=2.0 ** -9, atol=2.0 ** -22,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(got_p, want_p, err_msg=f"{k} step {step}")
                np.testing.assert_array_equal(got_r, want_r, err_msg=f"{k} step {step}")


# --------------------------------------------------------------------------
# The line-art cache and the masked micro step
# --------------------------------------------------------------------------

def _fake_encoders(calls: list):
    def encode_prompt(captions):
        return ([np.full((port_cache.CONTEXT_TOKENS, 8), 0.5, np.float32)] * len(captions),
                [np.arange(1, 9, dtype=np.int32)] * len(captions))

    def encode_image(pixels):
        calls.append(pixels)
        h, w, _ = pixels.shape
        return np.zeros((h // 8, w // 8, 4), np.float32)

    def encode_clip(frames):
        calls.append(frames[0])
        t, h, w, _ = frames.shape
        return np.zeros((1 + (t - 1) // 4, h // 8, w // 8, 4), np.float32)

    return port_cache.AnimaCacheEncoders(encode_prompt=encode_prompt,
                                         encode_image=encode_image,
                                         encode_clip=encode_clip)


@pytest.mark.parametrize("frames", [0, 5], ids=["images", "clips"])
def test_cache_builds_jax_lineart_masks(tmp_path, frames):
    """With the line-art loss on, every latent payload carries
    ``lineart_mask`` (lat_h, lat_w): JAX's ``_lineart_mask_for`` (cv2) of the
    image, or of a clip's first frame, within 1e-5, at two bucket shapes
    (640 x 640 and 896 x 512); JAX's check accepts the port's cache and its
    dataset reads the masks."""
    data = tmp_path / "d"
    for sub, size, seed in (("a", (64, 64), 4), ("b", (1024, 512), 5)):
        if frames:
            write_clip_dataset(data / sub, n_clips=1, frames=frames, image_size=size, seed=seed)
        else:
            write_image_dataset(data / sub, n_images=1, image_size=size, seed=seed)
    flat = {"TRAINING_MODE": "Anima DiT", "DIT_PATH": str(tmp_path / "none.safetensors"),
            "INSTANCE_DATASETS": [{"path": str(data), "repeats": 1}],
            "ANIMA_REPAIR_LINEART_LOSS_ENABLED": True, "MAX_BUCKET_RESOLUTION": 640,
            **({"ANIMA_VIDEO_FRAMES": frames} if frames else {})}
    config = RuntimeConfig(flat, validate_resume_paths=False)
    calls = []
    with contextlib.chdir(tmp_path):
        port_cache.precompute_and_cache_anima(config, _fake_encoders(calls))
        assert port_cache.check_if_anima_caching_needed(config) is False
        jax_config = JaxConfig(flat, validate_resume_paths=False)
        assert jax_cache.check_if_anima_caching_needed(jax_config) is False
        batch = jax_cache.AnimaLatentDataset(jax_config).fetch_batch([0])
    index = cs.load_index(data / port_cache.anima_cache_dir_name(config))
    pixels_of = {p.shape[:2]: p for p in calls}
    assert len(index["files"]) == len(pixels_of) == 2
    for item in index["files"]:
        lat, _ = cs.load_payload(item["lat_path"])
        h, w = lat["latents"].shape[-3:-1]
        want = jax_cache._lineart_mask_for(pixels_of[(8 * h, 8 * w)], h, w)
        got = lat["lineart_mask"]
        assert got.shape == want.shape == (h, w) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert 0.0 <= got.min() and got.max() <= 1.0 and got.max() > 0.1
    assert {k[-2:] for k in pixels_of} == {(640, 640), (512, 896)}
    assert batch["lineart_mask"].shape[1:] == batch["latents"].shape[-3:-1]


# --------------------------------------------------------------------------
# The repair CLI against JAX's
# --------------------------------------------------------------------------

QUANT = {"mlp.layer1.weight": "int8_tensorwise", "self_attn.q_proj.weight": "nvfp4"}
FLAT = {
    "TRAINING_MODE": "Anima DiT", "OUTPUT_NAME": "repair", "MAX_TRAIN_STEPS": 2,
    "BATCH_SIZE": 1, "GRADIENT_ACCUMULATION_STEPS": 1, "SAVE_EVERY_N_STEPS": 0,
    "SEED": 3, "MIXED_PRECISION": "bfloat16", "CLIP_GRAD_NORM": 1.0,
    "OPTIMIZER_TYPE": "raven", "LR_CUSTOM_CURVE": [[0.0, LR], [1.0, LR]],
    "ANIMA_DIT_SAVE_PREFIX": "auto",
}


def _repair_env(root: Path) -> int:
    """The TINY DiT in fp32 under ``dit.`` (``base``) and quantized by
    ``QUANT`` (``quant``), and a cache of two 8 x 8 latents with line-art
    masks. Returns the count of quantized tensors."""
    rng = np.random.default_rng(1)
    state = {k: v.numpy() for k, v in port_dit.params_from_jax(numpy_params(CFG, rng)).items()}
    write_streaming(root / "base.safetensors", {f"dit.{k}": v for k, v in state.items()})
    packed, n = {}, 0
    for key, arr in state.items():
        fmt = next((f for suffix, f in QUANT.items() if key.endswith(suffix)), None)
        if fmt is None:
            packed[key] = arr
            continue
        packed.update(q.quant_records_for_weight(key, arr, fmt))
        n += 1
    write_streaming(root / "quant.safetensors", {f"dit.{k}": v for k, v in packed.items()})
    cache_dir = root / "data" / ".precomputed_anima_dit_cache"
    files = []
    for i in range(2):
        te, lat = cs.te_path_for(cache_dir, f"i{i}"), cs.lat_path_for(cache_dir, f"i{i}")
        cs.save_payload(te, {
            "prompt_emb": rng.normal(size=(LS, CFG.adapter_source_dim)).astype(np.float32),
            "t5xxl_ids": rng.integers(1, CFG.adapter_vocab, LS).astype(np.int32)}, {})
        cs.save_payload(lat, {
            "latents": (rng.normal(size=(LAT, LAT, CFG.in_channels)) * 0.3).astype(np.float32),
            "lineart_mask": rng.uniform(size=(LAT, LAT)).astype(np.float32)}, {})
        files.append({"te_path": str(te), "lat_path": str(lat), "relative_path": f"i{i}.png",
                      "original_size": [64, 64], "scaled_size": [64, 64],
                      "target_size": [64, 64], "crop_coords": [0, 0],
                      "bucket_variant_index": 0})
    cs.save_index(cache_dir, {"version": 6, "cache_options": {}, "files": files})
    return n


def _preset(root: Path, out: str, dit: str, **overrides) -> Path:
    flat = {**FLAT, "DIT_PATH": str(root / dit), "OUTPUT_DIR": str(root / out),
            "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}], **overrides}
    path = root / f"{out}.json"
    path.write_text(json.dumps(schema.nest_flat_config(flat, "anima")))
    return path


def _in_fp32(from_argv, dtype):
    """``RuntimeConfig.from_argv`` with the compute dtype set to fp32 after
    parsing (the preset's ``MIXED_PRECISION`` has no fp32 value)."""
    def parse(argv=None):
        config = from_argv(argv)
        config.compute_dtype = dtype
        return config
    return parse


def _jax_grads_kept(clip, kept: list):
    """JAX's ``clip_by_global_norm`` that first hands each step's gradients
    (traced in a jitted step) to the host."""
    def clip_kept(grads, max_norm):
        jax.debug.callback(lambda g: kept.append({k: np.asarray(v) for k, v in g.items()}),
                           grads)
        return clip(grads, max_norm)
    return clip_kept


def _port_grads_kept(clip, kept: list):
    def clip_kept(grads, max_norm):
        kept.append({k: g.detach().float().numpy().copy() for k, g in grads.items()})
        return clip(grads, max_norm)
    return clip_kept


@pytest.fixture(scope="module")
def repair_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_repair")
    n_quant = _repair_env(root)
    noise = np.random.default_rng(5).normal(
        size=(4, 1, LAT, LAT, CFG.in_channels)).astype(np.float32)
    table = jnp.asarray(noise)
    jax_losses, port_losses, stdout = [], [], {}
    grads = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AOZORA_DEVICES", "1")
        mp.setenv("AOZORA_PLATFORM", "cpu")
        mp.setattr("tempfile.tempdir", str(root))   # JAX's dequantized temporary
        for cls, dtype in ((JaxConfig, jnp.float32), (RuntimeConfig, torch.float32)):
            mp.setattr(cls, "from_argv", _in_fp32(cls.from_argv, dtype))
        mp.setattr(jax_sdxl_obj, "noise_for_step", lambda seed, ms, shape: table[ms])
        mp.setattr(port_sdxl_obj, "noise_for_step",
                   lambda seed, ms, shape, device: torch.from_numpy(noise[ms]).to(device))
        mp.setattr(jax_reporter.MetricsReporter, "log_step",
                   _recording(jax_reporter.MetricsReporter, jax_losses))
        mp.setattr(port_reporter.MetricsReporter, "log_step",
                   _recording(port_reporter.MetricsReporter, port_losses))
        mp.setattr(jax_adamw, "clip_by_global_norm",
                   _jax_grads_kept(jax_adamw.clip_by_global_norm, grads["jax"]))
        # the cache has no source images (and no line-art cache options):
        # skip both rebuild checks, as JAX's repair CLI test does
        with mock.patch("aozora_sdxl_training_tpu.train.anima_trainer."
                        "check_if_anima_caching_needed", return_value=False), \
                mock.patch("aozora_sdxl_training_tpu_torch.train.anima_trainer."
                           "check_if_anima_caching_needed", return_value=False):
            jax_cli.main(["--config", str(_preset(root, "out_jax", "quant.safetensors"))])
            jax.effects_barrier()
            for name, preset in (
                    ("port", _preset(root, "out_port", "quant.safetensors")),
                    ("control", _preset(root, "out_control", "base.safetensors",
                                        ANIMA_REPAIR_TARGET_FORMAT="bf16"))):
                out = io.StringIO()
                with contextlib.redirect_stdout(out), pytest.MonkeyPatch.context() as kept:
                    if name == "port":
                        kept.setattr(port_adamw, "clip_by_global_norm",
                                     _port_grads_kept(port_adamw.clip_by_global_norm,
                                                      grads["port"]))
                    port_cli.main(["--config", str(preset)])
                stdout[name] = out.getvalue()
    return root, n_quant, jax_losses, port_losses, stdout, grads


def test_repair_losses_match_jax(repair_runs):
    """Both CLIs turn the line-art loss on (the preset does not set it),
    project after each optimizer step, and log the same losses (rtol 1e-5,
    fp32)."""
    _, n_quant, jax_losses, port_losses, stdout, _ = repair_runs
    out = stdout["port"]
    assert f"INFO: QAT repair: {n_quant} quantized tensors under prefix 'dit.'" in out
    assert "INFO: Cached line-art loss: enabled=True, max_weight=1.5x" in out
    assert f"INFO: on-device QAT projection active on {n_quant} tensor(s)" in out
    assert len(jax_losses) == 2 and all(np.isfinite(port_losses[:2]))
    np.testing.assert_allclose(port_losses[:2], jax_losses, rtol=1e-5)


def test_lineart_micro_step_matches_jax(repair_runs):
    """The first optimizer step's micro step, line-art mask on (strength
    0.5), in fp32 with the noise of one numpy table: its loss and every
    gradient, as each trainer hands them to the clip, against JAX's."""
    _, _, jax_losses, port_losses, _, grads = repair_runs
    assert len(grads["jax"]) == len(grads["port"]) == 2
    jax_grads, port_grads = grads["jax"][0], grads["port"][0]
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=1e-5)
    want = {k: v.numpy() for k, v in port_dit.params_from_jax(jax_grads).items()}
    assert port_grads.keys() == want.keys()
    for k, g in port_grads.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-4 * np.abs(want[k]).max() + 1e-12,
                                   err_msg=k)


def test_repaired_packed_checkpoint_matches_jax(repair_runs):
    """The packed files: the same records under ``dit.``, dtypes and shapes
    equal; per controlled tensor at least 99.9% of the codes equal to JAX's
    (none more than one code apart) and the scales within 1e-4; the port's
    file reloads in its controller with every format and shape unchanged.
    Prints the share of codes the repair moved from the input."""
    root, n_quant, _, _, _, _ = repair_runs
    port = load_all(root / "out_port" / "repaired_quantized.safetensors")
    ref = load_all(root / "out_jax" / "repaired_quantized.safetensors")
    inp = load_all(root / "quant.safetensors")
    assert port.keys() == ref.keys() == inp.keys()
    for key in port:
        assert port[key].dtype == ref[key].dtype and port[key].shape == ref[key].shape, key
    ctl = ProjectedQuantController({k[4:]: v for k, v in port.items()})
    ctl_in = ProjectedQuantController({k[4:]: v for k, v in inp.items()})
    assert ctl.formats == ctl_in.formats and len(ctl.formats) == n_quant
    for key, fmt in ctl.formats.items():
        codes, want, before = (np.asarray(s[f"dit.{key}"]) for s in (port, ref, inp))
        if fmt == "nvfp4":
            codes, want, before = (q.unpack_uint4(c) for c in (codes, want, before))
        same = np.mean(codes == want)
        moved, jax_moved = np.mean(codes != before), np.mean(want != before)
        step = np.abs(codes.astype(np.int32) - want.astype(np.int32)).max()
        print(f"{key} ({fmt}): {same:.4f} of codes equal to JAX's, {moved:.4f} moved "
              f"({jax_moved:.4f} in JAX's), largest code difference {step}")
        assert same >= 0.999 and step <= 1, key
        for suffix in (".weight_scale", ".weight_scale_2"):
            name = f"dit.{key[:-7]}{suffix}"
            if name in port:
                got, exp = (np.asarray(s[name]).astype(np.float32) for s in (port, ref))
                np.testing.assert_allclose(got, exp, rtol=1e-4, err_msg=name)
    dequant = ctl.dequantized_params()
    assert all(dequant[k].shape == ctl_in.dequantized_params()[k].shape for k in ctl.formats)
    assert load_all(root / "out_port" / "repair.safetensors").keys() == \
        load_all(root / "out_jax" / "repair.safetensors").keys()


def test_bf16_control_arm_trains_without_projection(repair_runs):
    root, _, _, port_losses, stdout, _ = repair_runs
    out = stdout["control"]
    assert "INFO: BF16 repair-control training enabled." in out
    assert "INFO: Cached line-art loss: enabled=True" in out
    assert "QAT projection" not in out
    assert len(port_losses) == 4 and all(np.isfinite(port_losses[2:]))
    saved = load_all(root / "out_control" / "repair.safetensors")
    assert saved.keys() == load_all(root / "base.safetensors").keys()
    assert not (root / "out_control" / "repaired_quantized.safetensors").exists()


def test_repair_cli_is_refused_under_torchrun(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match=re.escape("WORLD_SIZE > 1")):
        port_cli.main(["--config", str(tmp_path / "missing.json")])


def test_trainer_refuses_pipeline_parallelism_with_a_projector(tmp_path):
    """As JAX's trainer: the projector's formats are keyed by flat tensor
    names, so a projector with PIPELINE_PARALLEL_SIZE > 1 is refused by name
    before anything loads."""
    config = RuntimeConfig({**FLAT, "DIT_PATH": str(tmp_path / "none.safetensors"),
                            "OUTPUT_DIR": str(tmp_path / "out"), "PIPELINE_PARALLEL_SIZE": 2},
                           validate_resume_paths=False)
    projector = port_proj.make_device_projector({"w.weight": "int8_tensorwise"})
    with pytest.raises(SystemExit, match="QAT repair trainer"):
        port_trainer.run_anima_training(config, device="cpu", device_projector=projector)
