"""PyTorch port: the quant tools against the JAX package's.

The numpy tools are copies (``tools/quantize``, ``quant_profile``,
``convert_quants``, ``gguf_export``, ``diff_checker``, ``key_repair``,
``hash_checker``): on the same numpy inputs their records, files, reports
and stdout are equal byte for byte. ``semantic_maps`` is rewritten without
cv2: its maps are held against JAX's (cv2) at 1e-5 absolute on values in
[0, 1] (the blurs' taps applied in another order move a float32 ulp,
which the percentile scaling scales) at two bucket shapes.
``profile_quants`` runs the port's DiT (fp32, no remat, on the CPU here):
its forward is held against JAX's at 1e-4 of the output's largest
magnitude (XLA and PyTorch sum in other orders), and the dynamic mode's
assignment and checkpoint are JAX's.
"""

import contextlib
import io
import json
from dataclasses import replace
from unittest import mock

import jax
import numpy as np
import pytest
from PIL import Image, ImageDraw

from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.tools import convert_quants as jax_convert
from aozora_sdxl_training_tpu.tools import diff_checker as jax_diff
from aozora_sdxl_training_tpu.tools import gguf_export as jax_gguf
from aozora_sdxl_training_tpu.tools import hash_checker as jax_hash
from aozora_sdxl_training_tpu.tools import key_repair as jax_keys
from aozora_sdxl_training_tpu.tools import profile_quants as jax_profile
from aozora_sdxl_training_tpu.tools import quant_profile as jax_qp
from aozora_sdxl_training_tpu.tools import quantize as jax_q
from aozora_sdxl_training_tpu.tools import semantic_maps as jax_maps
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import write_streaming
from aozora_sdxl_training_tpu_torch.data import cache_store as cs
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.tools import convert_quants as port_convert
from aozora_sdxl_training_tpu_torch.tools import diff_checker as port_diff
from aozora_sdxl_training_tpu_torch.tools import gguf_export as port_gguf
from aozora_sdxl_training_tpu_torch.tools import hash_checker as port_hash
from aozora_sdxl_training_tpu_torch.tools import key_repair as port_keys
from aozora_sdxl_training_tpu_torch.tools import profile_quants as port_profile
from aozora_sdxl_training_tpu_torch.tools import quant_profile as port_qp
from aozora_sdxl_training_tpu_torch.tools import quantize as port_q
from aozora_sdxl_training_tpu_torch.tools import semantic_maps as port_maps

from tests.test_torch_port_anima_dit import numpy_params
from tests.test_torch_port_anima_trainer import CFG as TINY_CFG
from tests.test_torch_port_trainer import one_thread

CFG = replace(TINY_CFG, num_blocks=1, adapter_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def tiny_state():
    """The TINY DiT (one block) in torch layout, fp32."""
    return {k: v.numpy() for k, v in port_dit.params_from_jax(
        numpy_params(CFG, np.random.default_rng(3))).items()}


def _same_records(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _stdout(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8", "nvfp4", "ternary",
                                 "convert_state_dict"])
def test_quant_records_match_jax(fmt, tiny_state):
    """One weight with rows of very different scales through each format
    (records and the dequantized weight), or the whole TINY state through
    ``convert_state_dict`` (nvfp4 with a multiplier, the broad preset, an
    include and an exclude pattern, fp16 for the rest): byte for byte."""
    if fmt == "convert_state_dict":
        kw = dict(format_choice="nvfp4", preset="broad", keep_dtype=np.float16,
                  min_elements=256, include_patterns=(r"t_embedder\.1\.linear_1",),
                  exclude_patterns=(r"cross_attn",), nvfp4_scale_multiplier=0.75)
        got, got_report = port_q.convert_state_dict(tiny_state, **kw)
        want, want_report = jax_q.convert_state_dict(tiny_state, **kw)
        assert got_report == want_report and got_report["quantized"] > 4
        _same_records(got, want)
        return
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(48, 80)) * rng.uniform(1e-3, 2.0, size=(48, 1))).astype(np.float32)
    name = port_q.FORMAT_CHOICES[fmt]
    got = dict(port_q.quant_records_for_weight("blocks.0.w.weight", w, name, 0.9))
    want = dict(jax_q.quant_records_for_weight("blocks.0.w.weight", w, name, 0.9))
    _same_records(got, want)
    a = port_q.dequantize_records("blocks.0.w.weight", got, out_shape=w.shape)
    b = jax_q.dequantize_records("blocks.0.w.weight", want, out_shape=w.shape)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("tool", ["convert_quants", "gguf_export", "key_repair"])
def test_tool_files_match_jax(tool, tiny_state, tmp_path):
    """Each tool's CLI on one checkpoint: the same file, byte for byte, and
    the same stdout."""
    src = tmp_path / "dit.safetensors"
    write_streaming(src, {f"pipe.dit.{k}": v for k, v in tiny_state.items()})
    outs = {}
    for pkg, mod in (("port", {"convert_quants": port_convert, "gguf_export": port_gguf,
                               "key_repair": port_keys}[tool]),
                     ("jax", {"convert_quants": jax_convert, "gguf_export": jax_gguf,
                              "key_repair": jax_keys}[tool])):
        dst = tmp_path / f"{pkg}.out"
        args = {"convert_quants": ["--format", "int8", "--preset", "broad",
                                   "--min-elements", "256", "--exclude", "adaln"],
                "gguf_export": ["--quant", "q5_0"],
                "key_repair": ["--prefix", "model.diffusion_model"]}[tool]
        _, out = _stdout(mod.main, [str(src), str(dst), *args])
        outs[pkg] = (dst.read_bytes(), out.replace(str(dst), "OUT"))
    assert outs["port"] == outs["jax"]
    if tool == "key_repair":
        assert port_keys.detect_prefix(src) == jax_keys.detect_prefix(src) == "pipe.dit."


def test_diff_report_matches_jax(tiny_state, tmp_path):
    """A dense fine-tune and a rank-2 merge of the TINY state: the reports,
    the LoRA-merge verdicts, the per-block summaries, the CSVs and the
    CLI's stdout."""
    rng = np.random.default_rng(8)
    base = tmp_path / "base.safetensors"
    write_streaming(base, tiny_state)
    tuned = {}
    for k, v in tiny_state.items():
        if v.ndim == 2 and min(v.shape) >= 64:
            u, vt = rng.normal(size=(v.shape[0], 2)), rng.normal(size=(2, v.shape[1]))
            v = (v + 0.05 * u @ vt).astype(np.float32)
        elif v.ndim == 2:
            v = (v + 0.01 * rng.normal(size=v.shape)).astype(np.float32)
        tuned[k] = v
    tuned_path = tmp_path / "tuned.safetensors"
    write_streaming(tuned_path, tuned)
    got = port_diff.diff_checkpoints(base, tuned_path, svd_min_dim=64)
    want = jax_diff.diff_checkpoints(base, tuned_path, svd_min_dim=64)
    assert [vars(t) for t in got.tensors] == [vars(t) for t in want.tensors]
    assert got.merge_artifact_verdict() == want.merge_artifact_verdict()
    assert port_diff.per_block_summary(got) == jax_diff.per_block_summary(want)
    port_diff.export_csv(got, tmp_path / "port.csv")
    jax_diff.export_csv(want, tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    argv = [str(base), str(tuned_path)]
    assert _stdout(port_diff.main, argv)[1] == _stdout(jax_diff.main, argv)[1]


def test_hash_matches_jax_with_civitai_mocked(tmp_path):
    """SHA-256, AutoV2 and the legacy hash of one file, and the CLI's
    output with the Civitai lookup answered by a mock (no network)."""
    path = tmp_path / "model.safetensors"
    path.write_bytes(np.random.default_rng(1).integers(0, 256, 0x118000, np.uint8).tobytes())
    answer = io.BytesIO(json.dumps({"name": "v1", "model": {"name": "Tiny"}}).encode())
    reply = mock.MagicMock()
    reply.__enter__.return_value.read = lambda: answer.getvalue()
    outs = []
    for mod in (port_hash, jax_hash):
        with mock.patch("urllib.request.urlopen", return_value=reply) as urlopen:
            outs.append(_stdout(mod.main, [str(path), "--civitai", "--token", "t"])[1])
        request = urlopen.call_args.args[0]
        assert request.headers["Authorization"] == "Bearer t"
        assert request.full_url.endswith(port_hash.sha256_file(path))
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["civitai"] == {"name": "v1", "model": "Tiny"}
    assert port_hash.model_hash_legacy(path) == jax_hash.model_hash_legacy(path)


def test_quant_profiles_match_jax(tiny_state):
    """The three strategies with one numpy forward (the state's linear maps
    of a fixed input) and ``apply_profile``: the same assignments and the
    same records. The fast mode's threshold lies inside the layers' spread
    of local NVFP4 errors (0.0948-0.0957), so that both formats occur."""
    x = np.random.default_rng(4).normal(size=(8, CFG.model_channels)).astype(np.float32)
    keys = [k for k, v in tiny_state.items() if v.ndim == 2 and v.shape[1] == x.shape[1]]

    def forward(state):
        return np.concatenate([x @ np.asarray(state[k], np.float32).T for k in keys], axis=1)

    for mod_qp in (port_qp, jax_qp):
        assert mod_qp.LADDER == port_qp.LADDER
    got = (port_qp.fast_dynamic_profile(tiny_state, promote_threshold=0.0953),
           port_qp.global_dynamic_profile(tiny_state, forward, format_name="int8_tensorwise",
                                          promote_threshold=0.0016, max_layers=6),
           port_qp.compression_first_profile(tiny_state, forward, error_budget=0.05))
    want = (jax_qp.fast_dynamic_profile(tiny_state, promote_threshold=0.0953),
            jax_qp.global_dynamic_profile(tiny_state, forward, format_name="int8_tensorwise",
                                          promote_threshold=0.0016, max_layers=6),
            jax_qp.compression_first_profile(tiny_state, forward, error_budget=0.05))
    assert got == want
    assert len(set(got[0].values())) > 1 and len(set(got[1].values())) > 1
    a, a_report = port_qp.apply_profile(tiny_state, got[2])
    b, b_report = jax_qp.apply_profile(tiny_state, want[2])
    assert a_report == b_report
    _same_records(a, b)


def test_profile_quants_dynamic_matches_jax(tiny_state, tmp_path, monkeypatch):
    """``--mode dynamic`` on the TINY DiT with a trainer cache for
    calibration: the calibration batch, the forward (fp32) and the
    written checkpoint and report are JAX's. JAX's DiT forward is jitted
    here: its CLI calls it op by op, whose first call compiles each op
    (about 12 s for this DiT)."""
    monkeypatch.setattr(jax_dit, "dit_forward", jax.jit(
        jax_dit.dit_forward, static_argnames=("cfg", "attn_impl", "compute_dtype", "remat")))
    ckpt = tmp_path / "dit.safetensors"
    write_streaming(ckpt, {f"dit.{k}": v for k, v in tiny_state.items()})
    rng = np.random.default_rng(0)
    cache = tmp_path / "cache"
    files = []
    for i in range(3):
        lat, te = cs.lat_path_for(cache, f"img_{i}"), cs.te_path_for(cache, f"img_{i}")
        cs.save_payload(lat, {"latents": rng.normal(size=(8, 8, CFG.in_channels))
                              .astype(np.float32)}, {"cache_options": {}})
        cs.save_payload(te, {"prompt_emb": rng.normal(size=(16, CFG.adapter_source_dim))
                             .astype(np.float32),
                             "t5xxl_ids": rng.integers(1, 100, 7).astype(np.int32)},
                        {"cache_options": {}, "caption": f"test {i}"})
        files.append({"lat_path": str(lat), "te_path": str(te), "target_size": [64, 64],
                      "original_size": [64, 64], "relative_path": f"img_{i}.png"})
    cs.save_index(cache, {"files": files})
    got, _ = _stdout(port_profile.load_calibration_batch, cache, max_samples=2)
    want, _ = _stdout(jax_profile.load_calibration_batch, cache, max_samples=2)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    port_fwd = port_profile.build_forward_fn(tiny_state, calib_batch=got, device="cpu")
    jax_fwd = jax_profile.build_forward_fn(tiny_state, calib_batch=want)
    out, ref = port_fwd(tiny_state), jax_fwd(tiny_state)
    assert out.shape == ref.shape == (2, 1, 8, 8, CFG.out_channels)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())

    reports = {}
    with mock.patch.dict("os.environ", {"AOZORA_PLATFORM": "cpu"}):
        for name, mod in (("port", port_profile), ("jax", jax_profile)):
            _, text = _stdout(mod.main, [str(ckpt), str(tmp_path / f"{name}.safetensors"),
                                         "--mode", "dynamic", "--format", "int8",
                                         "--preset", "target", "--max-layers", "4",
                                         "--promote-threshold", "0.002",
                                         "--cache-dir", str(cache), "--calib-samples", "2"])
            reports[name] = json.loads(text[text.index("{"):])
    assert reports["port"] == reports["jax"]
    assert sum(reports["port"]["assignment_counts"].values()) == 4
    assert ((tmp_path / "port.safetensors").read_bytes()
            == (tmp_path / "jax.safetensors").read_bytes())


def _line_art(size, seed):
    """A white page with dark strokes of 1-3 px (``size`` (w, h))."""
    rng = np.random.default_rng(seed)
    w, h = size
    image = Image.fromarray(rng.uniform(200, 255, (h, w, 3)).astype(np.uint8))
    draw = ImageDraw.Draw(image)
    for _ in range(60):
        draw.line([tuple(int(c) for c in rng.integers(0, (w, h))) for _ in range(2)],
                  fill=tuple(int(c) for c in rng.integers(0, 120, 3)),
                  width=int(rng.integers(1, 4)))
    return image


@pytest.mark.parametrize("size", [(640, 640), (896, 512)])
def test_semantic_maps_match_cv2(size):
    """The detail map, the 4x oversampled line-art map and the latent loss
    weights of one line-art page per bucket shape, within 1e-5 of JAX's
    cv2 versions; a non-integer reduction raises."""
    image = _line_art(size, seed=size[1])
    lat_w, lat_h = size[0] // 8, size[1] // 8
    pairs = (
        (port_maps.generate_illustration_detail_map(image),
         jax_maps.generate_illustration_detail_map(image)),
        (port_maps.generate_lineart_loss_map(image, lat_h, lat_w),
         jax_maps.generate_lineart_loss_map(image, lat_h, lat_w)),
        (port_maps.loss_weight_mask_for_latents(image, lat_h, lat_w, detail_weight=2.0),
         jax_maps.loss_weight_mask_for_latents(image, lat_h, lat_w, detail_weight=2.0)))
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert pairs[0][0].max() == 1.0 and pairs[1][0].shape == (1, 4 * lat_h, 4 * lat_w)
    with pytest.raises(ValueError, match="integer reduction"):
        port_maps.area_reduce(pairs[0][0], lat_h + 1, lat_w)
