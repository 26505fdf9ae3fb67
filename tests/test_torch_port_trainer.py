"""PyTorch port: the SDXL training CLI against the JAX trainer, end to end.

Both run on one TINY checkpoint (numpy weights written in SD keys with an
``.arch.json`` sidecar) and one cache written by the port's cache_store
(the JAX trainer reads the same files), with one numpy noise table patched
into both packages' noise functions. The port runs through its CLI on the
CPU (``AOZORA_PLATFORM=cpu``); the JAX trainer on one CPU device.

Both save at each optimizer step (model + training state). Within the
same patches the port's CLI then resumes twice from optimizer step 1: from
its own files and from the JAX trainer's.

Also here: the CLI's stdout passes the reference GUI's grammar, the
port's cache check accepts the synthetic dataset (as does the JAX
package's), the CLI refuses to run without CUDA unless asked for the CPU,
each forced low-memory rung runs, saves and prints the JAX planner's
lines (the host moments also resume), and no module of the port imports
JAX.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import aozora_sdxl_training_tpu.train.reporter as jax_reporter
from aozora_sdxl_training_tpu.config.runtime import RuntimeConfig as JaxConfig
from aozora_sdxl_training_tpu.data import cache_builder as jax_cache_builder
from aozora_sdxl_training_tpu.data import cache_store as jax_cache_store
from aozora_sdxl_training_tpu.models.sdxl.arch import TINY
from aozora_sdxl_training_tpu.train import objectives as jax_obj
from aozora_sdxl_training_tpu.train.trainer import run_sdxl_training
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import (
    load_all, read_header, read_metadata, write_streaming)
from aozora_sdxl_training_tpu_torch.cli import train_sdxl as port_cli
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
from aozora_sdxl_training_tpu_torch.data import cache_builder as port_cache_builder
from aozora_sdxl_training_tpu_torch.data import cache_store as cs
from aozora_sdxl_training_tpu_torch.data.synthetic import write_synthetic_dataset
from aozora_sdxl_training_tpu_torch.data.tokenization import HashTokenizer
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import (
    params_from_jax, sd_state_from_params)
import aozora_sdxl_training_tpu_torch.train.reporter as port_reporter
from aozora_sdxl_training_tpu_torch.train import trainer as port_trainer
from aozora_sdxl_training_tpu_torch.train import objectives as port_obj

from tests.test_torch_port_unet import numpy_params

REPO = Path(__file__).resolve().parents[1]
LAT, SEQ, STEPS, GA = 8, 10, 4, 2
LR = 1e-4
FLAT = {
    "OUTPUT_NAME": "run",
    "MAX_TRAIN_STEPS": STEPS,
    "BATCH_SIZE": 1,
    "GRADIENT_ACCUMULATION_STEPS": GA,
    "SAVE_EVERY_N_STEPS": 0,
    "PREDICTION_TYPE": "v_prediction",
    "SEED": 11,
    "UNET_EXCLUDE_TARGETS": "conv1, conv2",
    "MIXED_PRECISION": "bfloat16",
    "CLIP_GRAD_NORM": 1.0,
    "OPTIMIZER_TYPE": "raven",
    "LR_CUSTOM_CURVE": [[0.0, LR], [1.0, LR]],
}


def _build_env(root: Path, unet_cfg=TINY):
    rng = np.random.default_rng(21)
    ckpt = root / "base.safetensors"
    sd = sd_state_from_params(params_from_jax(numpy_params(unet_cfg, rng)),
                              dtype=torch.float32)
    tensors = {k: v.numpy() for k, v in sd.items()}
    tensors["first_stage_model.dummy"] = np.ones((3,), np.float32)
    write_streaming(ckpt, tensors)
    Path(str(ckpt) + ".arch.json").write_text(json.dumps(asdict(unet_cfg)))

    cache_dir = root / "data" / cs.sdxl_cache_dir_name(False)
    options = {"cache_schema_version": 1}
    files = []
    for i in range(4):
        te_path, lat_path = cs.te_path_for(cache_dir, f"img{i}"), cs.lat_path_for(cache_dir, f"img{i}")
        cs.save_payload(te_path, {
            "embeds": rng.normal(size=(SEQ, TINY.cross_attention_dim)).astype(np.float32),
            "pooled": rng.normal(size=(TINY.pooled_projection_dim,)).astype(np.float32),
        }, {"cache_options": options})
        cs.save_payload(lat_path, {
            "latents": (rng.normal(size=(LAT, LAT, 4)) * 0.2).astype(np.float32),
        }, {"cache_options": options})
        files.append({"te_path": str(te_path), "lat_path": str(lat_path),
                      "relative_path": f"img{i}.png", "original_size": [640, 640],
                      "scaled_size": [640, 640], "target_size": [LAT * 8, LAT * 8],
                      "crop_coords": [0, 0], "bucket_variant_index": 0})
    cs.save_index(cache_dir, {"version": 13, "cache_options": options,
                              "files": files})
    return ckpt


def _flat(root: Path, out: str, **overrides) -> dict:
    return {**FLAT,
            "SINGLE_FILE_CHECKPOINT_PATH": str(root / "base.safetensors"),
            "OUTPUT_DIR": str(root / out),
            "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}],
            **overrides}


def _resume_flat(root: Path, out: str, source: str) -> dict:
    """Resume from ``source``'s files of optimizer step 1, into ``out``."""
    return _flat(root, out, RESUME_TRAINING=True,
                 RESUME_MODEL_PATH=str(root / source / "run_step_1.safetensors"),
                 RESUME_STATE_PATH=str(root / source / "run_training_state_step_1.safetensors"))


@contextlib.contextmanager
def one_thread():
    """Torch's CPU kernels on one thread. A TINY port run is thousands of
    small eager ops, and a suite of several workers, each with a thread a
    core, oversubscribes the cores: one run took ~3 s on one thread and
    ~650 s on eight with six runs at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _run_port_cli(root: Path, name: str, flat: dict) -> str:
    """The port's SDXL CLI on ``flat`` (on one thread); returns its stdout."""
    preset = root / f"{name}.json"
    preset.write_text(json.dumps(schema.nest_flat_config(flat, "sdxl")))
    out = io.StringIO()
    with one_thread(), contextlib.redirect_stdout(out):
        port_cli.main(["--config", str(preset)])
    return out.getvalue()


def _recording(reporter_cls, losses):
    original = reporter_cls.log_step

    def log_step(self, micro_step, *, loss, **kw):
        losses.append(loss)
        return original(self, micro_step, loss=loss, **kw)
    return log_step


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and port runs, then the port resumed from its own step-1 files
    ("resumed") and from the JAX run's ("from_jax"). Returns (root, JAX
    losses, port losses, {resumed run: stdout}); the port's losses are the
    unbroken run's 4 micro steps, then each resumed run's 2."""
    root = tmp_path_factory.mktemp("port_trainer")
    _build_env(root)
    noise = np.random.default_rng(5).normal(
        size=(STEPS + 1, 1, LAT, LAT, 4)).astype(np.float32)
    table = jnp.asarray(noise)
    jax_losses, port_losses = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AOZORA_DEVICES", "1")
        mp.setenv("AOZORA_PLATFORM", "cpu")
        mp.setattr(jax_obj, "noise_for_step", lambda seed, ms, shape: table[ms])
        mp.setattr(port_obj, "noise_for_step",
                   lambda seed, ms, shape, device: torch.from_numpy(noise[ms]).to(device))
        mp.setattr(jax_reporter.MetricsReporter, "log_step",
                   _recording(jax_reporter.MetricsReporter, jax_losses))
        mp.setattr(port_reporter.MetricsReporter, "log_step",
                   _recording(port_reporter.MetricsReporter, port_losses))
        # the cache is synthetic (no source images): skip both rebuild checks
        with mock.patch("aozora_sdxl_training_tpu.train.trainer."
                        "check_if_caching_needed", return_value=False), \
                mock.patch("aozora_sdxl_training_tpu_torch.train.trainer."
                           "check_if_caching_needed", return_value=False):
            run_sdxl_training(JaxConfig(_flat(root, "out_jax", SAVE_EVERY_N_STEPS=1),
                                        validate_resume_paths=False),
                              unet_cfg=TINY)
            _run_port_cli(root, "preset", _flat(root, "out_port", SAVE_EVERY_N_STEPS=1))
            resumed = {name: _run_port_cli(root, name, _resume_flat(root, f"out_{name}", source))
                       for name, source in (("resumed", "out_port"), ("from_jax", "out_jax"))}
    return root, jax_losses, port_losses, resumed


def test_losses_match_jax_trainer(runs):
    """Per-micro-step losses. Both compute the UNet in bf16, rounding at
    different places (XLA fusions vs eager ops); over a TINY forward that
    moves the loss by well under 1%: rtol 1e-2."""
    _, jax_losses, port_losses, _ = runs
    assert len(port_losses) == STEPS + 2 * (STEPS - GA) and len(jax_losses) == STEPS
    assert all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses[:STEPS], jax_losses, rtol=1e-2)


def test_merged_checkpoint_matches_jax_trainer(runs):
    """Final merged UNet tensors (BF16 on disk) after two optimizer steps.

    With debias 0.3, Adam's first step moves an element by at most 3.63 lr
    and its second by at most 4.71 lr (Cauchy-Schwarz over the two
    gradients in m and v), whatever the gradients' size. Where bf16 compute
    noise flips the sign of a tiny gradient, the two runs can part by twice
    the sum, 1.67e-3 in fp32; the save then rounds each side to bf16, which
    adds at most one bf16 ulp (2^-7 of the value): that is the elementwise
    bound. Since nearly every element takes a full-size Adam step, the
    whole update (merged minus base) has the same norm in both runs (within
    1%), and its direction differs only where gradients sit below the bf16
    compute noise (cosine >= 0.95). The frozen conv1/conv2 tensors are
    bit-identical."""
    root, _, _, _ = runs
    port = load_all(root / "out_port" / "run.safetensors")
    ref = load_all(root / "out_jax" / "run.safetensors")
    base = load_all(root / "base.safetensors")
    assert port.keys() == ref.keys()
    header = read_header(root / "out_port" / "run.safetensors")
    assert header["first_stage_model.dummy"]["dtype"] == "BF16"
    unet = [k for k in ref if k.startswith("model.diffusion_model.")]
    assert unet and all(header[k]["dtype"] == "BF16" for k in unet)
    upd_port, upd_ref = [], []
    for key in unet:
        a = np.asarray(port[key], np.float32)
        b = np.asarray(ref[key], np.float32)
        if ".in_layers.2." in key or ".out_layers.3." in key:   # conv1/conv2
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


@pytest.mark.parametrize("name,source", [("resumed", "port"), ("from_jax", "jax")])
def test_resumed_run_reproduces_the_unbroken_run(runs, name, source):
    """The port resumed from optimizer step 1's files (its own, or the JAX
    trainer's) runs micro steps 3-4 and optimizer step 2 with the unbroken
    run's losses: rtol 1e-2. The model file holds bf16-rounded masters (as
    in JAX and the reference), so the resumed run starts from weights up to
    2^-9 of their size away; over the TINY UNet that moves a loss by well
    under 1%, as does the bf16 compute the tolerance already covers."""
    _, jax_losses, port_losses, resumed = runs
    unbroken = (port_losses if source == "port" else jax_losses)[GA:STEPS]
    start = STEPS + (0 if name == "resumed" else STEPS - GA)
    got = port_losses[start:start + STEPS - GA]
    print(f"{name}: first resumed step's loss {got[0]!r} against {unbroken[0]!r} "
          f"(relative difference {abs(got[0] - unbroken[0]) / unbroken[0]:.3e})")
    np.testing.assert_allclose(got, unbroken, rtol=1e-2)
    out = resumed[name]
    assert "--- RESUMING TRAINING SESSION ---" in out
    assert "INFO: Restored optimizer state from resume checkpoint." in out
    steps = [int(m) for m in re.findall(r"--- Optimizer Step: (\d+)", out)]
    assert steps == [2]


def test_state_files_match_jax_trainer(runs):
    """Both trainers' step-1 training states: the same tensors (bf16
    moments in the JAX layout, ``opt.step``; the JAX file orders them by
    name) and metadata, and moments that
    point the same way (bf16 compute noise apart: cosine >= 0.99)."""
    root = runs[0]
    name = "run_training_state_step_1.safetensors"
    port_file, jax_file = root / "out_port" / name, root / "out_jax" / name
    specs = [{k: (v["dtype"], v["shape"]) for k, v in read_header(f).items()}
             for f in (port_file, jax_file)]
    assert specs[0] == specs[1]
    meta = json.loads(read_metadata(port_file)["json"])
    assert meta == json.loads(read_metadata(jax_file)["json"])
    assert meta["global_step"] == 1 and meta["micro_step"] == GA
    assert meta["schedule_global_batch"] == 1 and meta["sampler_seed"] == FLAT["SEED"]
    port, ref = load_all(port_file), load_all(jax_file)
    assert int(port["opt.step"]) == int(ref["opt.step"]) == 1
    for prefix in ("m.", "v."):
        keys = [k for k in ref if k.startswith(prefix)]
        assert keys and all(ref[k].dtype == ml_dtypes.bfloat16 for k in keys)
        a = np.concatenate([np.asarray(port[k], np.float32).ravel() for k in keys])
        b = np.concatenate([np.asarray(ref[k], np.float32).ravel() for k in keys])
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99


def test_cli_stdout_matches_gui_grammar(runs):
    """The port SDXL CLI's stdout (the run resumed from its own step-1
    files) through every channel of the reference GUI
    (``tests/test_gui_grammar.py::_audit``): progress with Timestep, the
    optimizer block, grad norms, the parameter-info line; no error
    keyword; no line parses as Anima progress."""
    from tests.test_gui_grammar import ANIMA_PROGRESS, SDXL_PROGRESS, _audit, _gui_lines
    lines = _gui_lines(runs[3]["resumed"])
    hits = _audit(lines, SDXL_PROGRESS, expect_sigma=False)
    assert hits["progress"] >= STEPS - GA and hits["optim"] >= 1 and hits["grad"] >= 1, hits
    assert hits["param_info"] == 1 and hits["error"] == 0, hits
    assert all(not ANIMA_PROGRESS.search(line) for line in lines)


def test_cache_check_accepts_synthetic_dataset(tmp_path):
    """The synthetic dataset + cache pass the real cache check of both
    packages (same index, payload metadata and signatures); after a caption
    edit the port's rebuild encodes that caption alone and keeps the
    synthetic latents."""
    flat = {**FLAT, "INSTANCE_DATASETS": [{"path": str(tmp_path / "d"), "repeats": 1}],
            "SINGLE_FILE_CHECKPOINT_PATH": str(tmp_path / "none.safetensors")}
    config = RuntimeConfig(flat, validate_resume_paths=False)
    write_synthetic_dataset(tmp_path / "d", config, n_images=2,
                            image_size=(96, 64), seq_len=SEQ,
                            embed_dim=TINY.cross_attention_dim,
                            pooled_dim=TINY.pooled_projection_dim)
    assert port_cache_builder.check_if_caching_needed(config) is False
    assert jax_cache_builder.check_if_caching_needed(
        JaxConfig(flat, validate_resume_paths=False)) is False
    (tmp_path / "d" / "img0.txt").write_text("edited caption")
    assert port_cache_builder.check_if_caching_needed(config) is True

    def no_latents(pixels):
        raise AssertionError("the latents were re-encoded")

    encoded = []
    encoders = port_cache_builder.SdxlCacheEncoders(
        encode_text=lambda tl, tg: encoded.append(len(tl)) or (
            np.zeros((len(tl), 77, TINY.cross_attention_dim), np.float32),
            np.zeros((len(tl), TINY.pooled_projection_dim), np.float32)),
        encode_latents=no_latents, tokenizer_l=HashTokenizer(),
        tokenizer_g=HashTokenizer(), latent_normalizer=lambda x: x)
    port_cache_builder.precompute_and_cache(config, encoders)
    assert encoded == [1]
    assert port_cache_builder.check_if_caching_needed(config) is False
    _, meta = cs.load_payload(cs.te_path_for(tmp_path / "d" / cs.sdxl_cache_dir_name(False),
                                             "img0"))
    assert meta["caption"] == "edited caption"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_payloads_read_across_packages(tmp_path, writer):
    """A payload written by one package reads back bit for bit, metadata
    included, in the other."""
    rng = np.random.default_rng(3)
    tensors = {"embeds": rng.normal(size=(SEQ, 48)).astype(ml_dtypes.bfloat16),
               "pooled": rng.normal(size=(40,)).astype(np.float32)}
    meta = {"cache_options": {"cache_schema_version": 1}, "caption": "a b"}
    save, load = ((jax_cache_store.save_payload, cs.load_payload)
                  if writer == "jax" else
                  (cs.save_payload, jax_cache_store.load_payload))
    save(tmp_path / "p.safetensors", tensors, meta)
    got, got_meta = load(tmp_path / "p.safetensors")
    assert got_meta == meta and got.keys() == tensors.keys()
    for name, want in tensors.items():
        arr = np.asarray(got[name])
        assert arr.dtype == want.dtype
        np.testing.assert_array_equal(arr, want, err_msg=name)


def test_cli_raises_without_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.delenv("AOZORA_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="AOZORA_PLATFORM=cpu"):
        port_cli.main(["--config", "missing.json"])


@pytest.mark.parametrize("rung", ["two_pass", "moments_host"])
def test_forced_rung_runs_saves_and_prints_the_jax_plan(tmp_path, monkeypatch, rung):
    """``AOZORA_LOWMEM_RUNG`` at GA 1: the CLI runs the rung's step (the
    two-pass step; the fused step with the moments in host memory) for two
    optimizer steps with finite losses, saves the model and the training
    state at each, and prints the JAX planner's lines for that rung on the
    same inputs. Under ``moments_host`` a run resumed from step 1's files
    (its state restored into host memory) repeats the unbroken run's step
    2 exactly: the bf16 masters are in the model file as they are, the
    int8 codes and scales come back bit for bit, and the tickets and noise
    are the step's."""
    from tests.test_torch_port_fused_step import _plan_lines
    from tests.test_torch_port_memory_policy import jax_plan_lines, recorded_plans
    _build_env(tmp_path)
    losses = []
    monkeypatch.setenv("AOZORA_LOWMEM_RUNG", rung)
    monkeypatch.setenv("AOZORA_PLATFORM", "cpu")
    monkeypatch.setenv("AOZORA_DEVICES", "1")
    monkeypatch.setattr(port_reporter.MetricsReporter, "log_step",
                        _recording(port_reporter.MetricsReporter, losses))
    flat = dict(GRADIENT_ACCUMULATION_STEPS=1, MAX_TRAIN_STEPS=2, SAVE_EVERY_N_STEPS=1)
    with recorded_plans() as plans, mock.patch.object(
            port_trainer, "check_if_caching_needed", return_value=False):
        out = _run_port_cli(tmp_path, "rung", _flat(tmp_path, "out", **flat))
        if rung == "moments_host":
            resumed = _run_port_cli(tmp_path, "resumed", {
                **_resume_flat(tmp_path, "out_resumed", "out"), **flat})
    lines = _plan_lines(out)
    assert lines == jax_plan_lines("sdxl", plans["sdxl"][0])
    assert ("two-pass step" in lines[2]) == (rung == "two_pass")
    assert ("OFFLOADED to pinned host memory" in lines[3]) == (rung == "moments_host")
    assert len(losses) >= 2 and all(np.isfinite(losses))
    assert [int(m) for m in re.findall(r"--- Optimizer Step: (\d+)", out)] == [1, 2]
    assert all((tmp_path / "out" / f"run{kind}_step_{n}.safetensors").exists()
               for kind in ("", "_training_state") for n in (1, 2))
    assert (tmp_path / "out" / "run.safetensors").exists()
    if rung == "moments_host":
        assert "INFO: Restored optimizer state from resume checkpoint." in resumed
        assert "Momentum state:      host memory int8_blockwise" in resumed
        assert _plan_lines(resumed) == lines
        assert losses[2:] == losses[1:2]


@pytest.mark.parametrize("master", ["auto", "float32"])
def test_fp32_master_dtypes_pass_the_check(tmp_path, master):
    config = RuntimeConfig({**_flat(tmp_path, "out"), "MASTER_DTYPE": master},
                           validate_resume_paths=False)
    assert config.MASTER_DTYPE == master


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke.py, imported in a fresh
    interpreter, leave jax, the JAX package, cv2 and PyQt out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import aozora_sdxl_training_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names + ['chip_smoke']: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] in ('aozora_sdxl_training_tpu', 'cv2', 'PyQt5',\n"
        "                                    'PyQt6'))\n"
        "new = {p.__name__ + '.' + n for n in ('ops.ring_attention', "
        "'ops.groupnorm_silu', 'parallel', 'parallel.sharding', 'parallel.pipeline', "
        "'parallel.p2p', 'tools.p2p_probe', "
        "'models.anima.qwen3', 'models.anima.wan_vae', 'models.anima.pipeline', "
        "'train.qat_project', 'train.qat_repair', 'cli.train_anima_repair', "
        "'tools.quantize', 'tools.semantic_maps', 'tools.profile_quants', "
        "'train.timestep_presets', 'gui.__main__', 'gui.app', 'gui.charts', "
        "'gui.curve_editor', 'gui.curve_models', 'gui.datasets_model', 'gui.log_buffer', "
        "'gui.metrics', 'gui.process_runner', 'gui.theme')}\n"
        "print(len(names), bad, sorted(new - set(names)))\n"
        "sys.exit(1 if bad or len(names) < 20 or not new <= set(names) else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
