"""PyTorch port: the GUI modules and the timestep presets against the JAX
package's.

* Every test of ``tests/test_gui_core.py``, ``test_gui_models.py``,
  ``test_curve_editor.py`` and ``test_timestep_presets.py`` runs again with
  its imports of the JAX package pointed at the port (one case a JAX test
  and parameter set): the port's copies keep the behaviour those tests pin.
* The same inputs go through both packages' modules and the outputs are
  equal, exactly (pure Python and numpy on both sides): the timestep
  distributions and presets, the curve editors' edit sequences and their
  preset JSON, the chart model's compaction and sampling, the stdout
  parser, the compressed log buffer, the dataset manager and the theme.
* The port's app launches the port's CLIs by module (``python -u -m
  aozora_sdxl_training_tpu_torch.cli.train_{sdxl,anima}``), never the root
  ``train.py`` / ``train_anima.py`` (which run the JAX package);
  ``process_runner`` starts such a module from any working directory; and
  without a display ``main()`` exits by ``SystemExit`` naming the port's
  CLI. Each launch has a timeout and kills its process group.
"""

import inspect
import itertools
import json
import re
import sys
import types
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

import aozora_sdxl_training_tpu.gui.charts as jax_charts
import aozora_sdxl_training_tpu.gui.curve_models as jax_curves
import aozora_sdxl_training_tpu.gui.datasets_model as jax_datasets
import aozora_sdxl_training_tpu.gui.log_buffer as jax_log
import aozora_sdxl_training_tpu.gui.metrics as jax_metrics
import aozora_sdxl_training_tpu.gui.theme as jax_theme
import aozora_sdxl_training_tpu.train.timestep_presets as jax_tp
import aozora_sdxl_training_tpu_torch.gui.app as port_app
import aozora_sdxl_training_tpu_torch.gui.charts as port_charts
import aozora_sdxl_training_tpu_torch.gui.curve_models as port_curves
import aozora_sdxl_training_tpu_torch.gui.datasets_model as port_datasets
import aozora_sdxl_training_tpu_torch.gui.log_buffer as port_log
import aozora_sdxl_training_tpu_torch.gui.metrics as port_metrics
import aozora_sdxl_training_tpu_torch.gui.process_runner as port_runner
import aozora_sdxl_training_tpu_torch.gui.theme as port_theme
import aozora_sdxl_training_tpu_torch.train.timestep_presets as port_tp

TESTS = Path(__file__).resolve().parent
JAX_GUI_TESTS = ("test_gui_core", "test_gui_models", "test_curve_editor",
                 "test_timestep_presets")
LAUNCH_TIMEOUT_S = 60


# --------------------------------------------------------------------------
# The JAX package's GUI tests, run on the port's modules
# --------------------------------------------------------------------------

def _port_side(name: str) -> types.ModuleType:
    """``tests/<name>.py`` with every import of the JAX package pointed at
    the port's module of the same path."""
    source = (TESTS / f"{name}.py").read_text()
    source = re.sub(r"\baozora_sdxl_training_tpu\.", "aozora_sdxl_training_tpu_torch.", source)
    module = types.ModuleType(f"port_side_{name}")
    module.__file__ = str(TESTS / f"{name}.py")
    exec(compile(source, f"<port side of tests/{name}.py>", "exec"), module.__dict__)
    return module


_MODULES = {name: _port_side(name) for name in JAX_GUI_TESTS}


def _expand(fn):
    """(id suffix, kwargs) for each parameter set of ``fn``'s parametrize
    marks."""
    axes = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in (mark.args[0].split(",") if isinstance(mark.args[0], str)
                                     else mark.args[0])]
        axes.append([dict(zip(names, v if len(names) > 1 else (v,))) for v in mark.args[1]])
    for combo in itertools.product(*axes):
        kwargs = {k: v for d in combo for k, v in d.items()}
        yield "-".join(str(v) for v in kwargs.values()), kwargs


def _cases():
    for name, module in _MODULES.items():
        for attr, obj in vars(module).items():
            owners = ([(None, attr, obj)] if attr.startswith("test_") and callable(obj) else
                      [(obj, m, f) for m, f in vars(obj).items() if m.startswith("test_")]
                      if attr.startswith("Test") and isinstance(obj, type) else [])
            for cls, fname, fn in owners:
                for suffix, kwargs in _expand(fn):
                    label = ".".join(p for p in (cls.__name__ if cls else None, fname) if p)
                    yield pytest.param(name, cls, fname, kwargs,
                                       id=f"{name}::{label}" + (f"[{suffix}]" if suffix else ""))


CASES = list(_cases())


def test_every_jax_gui_test_is_mirrored():
    """77 test functions (79 cases with their parameters) in the four files."""
    functions = {(c.values[0], c.values[1], c.values[2]) for c in CASES}
    assert len(functions) == 77 and len(CASES) == 79


@pytest.mark.parametrize("name,cls,fname,kwargs", CASES)
def test_jax_gui_test_passes_on_the_port(name, cls, fname, kwargs, tmp_path):
    fn = getattr(cls() if cls else _MODULES[name], fname)
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs = {**kwargs, "tmp_path": tmp_path}
    fn(**kwargs)


# --------------------------------------------------------------------------
# Both packages' modules on the same inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(jax_tp.PRESETS))
@pytest.mark.parametrize("bin_size", [7, 50, 100])
def test_presets_and_distributions_equal_jax(preset, bin_size):
    """Every preset's allocation, and its mode's weights at other settings
    (odds scales too), equal the JAX module's bit for bit."""
    assert port_tp.PRESETS == jax_tp.PRESETS
    assert (port_tp.allocation_from_preset(preset, bin_size)
            == jax_tp.allocation_from_preset(preset, bin_size))
    mode, params = jax_tp.PRESETS[preset]
    for extra in ({}, {"odds_scale": 0.4}, {"odds_scale": 5.0}):
        a = port_tp.distribution_weights(mode, bin_size, **params, **extra)
        b = jax_tp.distribution_weights(mode, bin_size, **params, **extra)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for mode in ("Odds-Scaled (Z-Image)", "Shift"):
        np.testing.assert_array_equal(
            np.asarray(port_tp.distribution_weights(mode, bin_size, odds_scale=2.5)),
            np.asarray(jax_tp.distribution_weights(mode, bin_size, odds_scale=2.5)))


def test_planning_helpers_equal_jax():
    datasets = [{"image_count": 12, "repeats": 3}, {"image_count": 5}, {"repeats": 2}]
    assert port_tp.repeated_image_count(datasets) == jax_tp.repeated_image_count(datasets)
    for args in [(1000, 4, 1, 37), (7, 0, 2, 0), (10, 1, 3, 10), (0, 2, 2, 5)]:
        assert port_tp.training_calculations(*args) == jax_tp.training_calculations(*args)
        assert (port_tp.epoch_marker_interval(args[0], args[2], args[3])
                == jax_tp.epoch_marker_interval(args[0], args[2], args[3]))


def _edit_curves(mod, rng):
    """One seeded sequence of edits on each curve model; returns every
    state it passes through."""
    seen = []
    lr = mod.LRCurveModel(min_lr=1e-7, max_lr=1e-3)
    hist = mod.TimestepHistogramModel(bin_size=50, max_tickets=1000)
    loss = mod.LossWeightCurveModel()
    for _ in range(40):
        op = int(rng.integers(0, 9))
        if op == 0:
            lr.add_point()
        elif op == 1:
            lr.remove_point(int(rng.integers(0, len(lr.get_points()))))
        elif op == 2:
            lr.move_point(int(rng.integers(0, len(lr.get_points()))),
                          float(rng.uniform(-0.2, 1.2)), float(rng.uniform(0, 2e-3)))
        elif op == 3:
            lr.set_standard_preset(["Cosine", "Linear", "Constant"][int(rng.integers(0, 3))])
        elif op == 4:
            hist.set_total_steps(int(rng.integers(100, 5000)))
        elif op == 5:
            hist.apply_distribution(["Wave", "Logit-Normal", "Beta"][int(rng.integers(0, 3))])
        elif op == 6:
            loss.add_point()
        elif op == 7:
            loss.move_point(int(rng.integers(0, len(loss.get_points()))),
                            float(rng.uniform(-0.2, 1.2)), float(rng.uniform(-1, 5)))
        else:
            (loss.apply_bell_preset if rng.integers(0, 2) else loss.apply_min_snr_like_preset)()
        seen.append(json.dumps([lr.get_points(), hist.get_allocation(), loss.get_points()]))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_curve_editing_equals_jax(seed):
    assert (_edit_curves(port_curves, np.random.default_rng(seed))
            == _edit_curves(jax_curves, np.random.default_rng(seed)))


@pytest.mark.parametrize("max_points", [300, 2000])
def test_chart_model_equals_jax(max_points):
    """The same appends (out of order, duplicate x) into both chart models:
    the same series after compaction, the same visible slices, min-max
    samples, view windows after zoom and pan, and nearest points."""
    rng = np.random.default_rng(max_points)
    xs = rng.integers(0, 1200, 1500).tolist()
    ys = rng.normal(size=1500).round(4).tolist()
    models = []
    for mod in (port_charts, jax_charts):
        m = mod.ChartModel("loss")
        m.add_line("step", max_points=max_points)
        m.add_line("ema", max_points=max_points)
        models.append(m)
    for x, y in zip(xs, ys):
        for m in models:
            m.append(x % 2, x, y)
    a, b = models
    for line in (0, 1):
        sa, sb = a.series[line], b.series[line]
        assert sa.data == sb.data
        for lo, hi in [(0, 1200), (50, 60), (1190, 1500)]:
            assert sa.visible_slice(lo, hi) == sb.visible_slice(lo, hi)
        assert port_charts.sample(sa.data, 25) == jax_charts.sample(sb.data, 25)
    for m in models:
        m.zoom_at(0.3, 0.5)
        m.pan_fraction(0.1)
    assert (a.data_range(), a.view_range(), a.nearest_point(611.0)) == (
        b.data_range(), b.view_range(), b.nearest_point(611.0))


def test_stdout_parser_and_log_buffer_equal_jax():
    """The same trainer-style lines (progress in both grammars, optimizer
    blocks, grad norms, preview and failure lines) through both
    ``LiveMetrics`` and both ``CompressedLogBuffer``s."""
    from aozora_sdxl_training_tpu_torch.train.reporter import optimizer_block, progress_line
    lines = []
    for i in range(30):
        lines.append(progress_line(i, 30, 0.5 + 0.01 * i, 10 * i,
                                   sigma=(0.03 * i if i % 2 else None),
                                   s_per_step=1.5, eta=20, elapsed=30))
        if i % 4 == 3:
            lines += optimizer_block(i // 4 + 1, 0.55, 1e-4 * (i + 1), 2.0, 2.1, 1.7,
                                     1.0, 3e-3).splitlines()
    lines += ["INFO: preview image saved -> out/previews/step_2.png",
              "RuntimeError: CUDA out of memory", "loss is nan at step 3"]
    parsers = [port_metrics.LiveMetrics(), jax_metrics.LiveMetrics()]
    logs = [port_log.CompressedLogBuffer(block_lines=7),
            jax_log.CompressedLogBuffer(block_lines=7)]
    for line in lines:
        assert parsers[0].parse_line(line) == parsers[1].parse_line(line)
        for log in logs:
            log.append(line)
    a, b = parsers
    for field in ("step_loss", "loss_ema", "optim_loss", "optim_loss_ema", "lr",
                  "grad_raw", "grad_clipped"):
        sa, sb = getattr(a, field), getattr(b, field)
        assert (list(sa.xs), list(sa.ys)) == (list(sb.xs), list(sb.ys)), field
    assert (list(a.timesteps), list(a.sigmas), a.failures, a.preview_paths,
            a.status_line()) == (list(b.timesteps), list(b.sigmas), b.failures,
                                 b.preview_paths, b.status_line())
    assert a.timestep_histogram(10) == b.timestep_histogram(10)
    assert a.mean_loss_by_sigma(8) == b.mean_loss_by_sigma(8)
    assert len(logs[0]) == len(logs[1]) == len(lines)
    assert logs[0].compressed_bytes == logs[1].compressed_bytes
    for start, count in [(0, 50), (3, 20), (len(lines) - 5, 10)]:
        assert logs[0].get_lines(start, count) == logs[1].get_lines(start, count)


def test_dataset_manager_and_theme_equal_jax(tmp_path):
    """Both dataset managers over the same folders (images with and
    without captions, repeats, sorting, removal, cache folders by mode and
    clearing) and both themes' palettes, overrides and saved state."""
    from PIL import Image
    for d, n in (("a", 3), ("b", 2)):
        (tmp_path / d).mkdir()
        for i in range(n):
            Image.new("RGB", (4 + i, 4)).save(tmp_path / d / f"img{i}.png")
            if i % 2 == 0:
                (tmp_path / d / f"img{i}.txt").write_text(f"caption {i}")
    states = []
    for mod in (port_datasets, jax_datasets):
        mgr = mod.DatasetManager([{"path": str(tmp_path / "a"), "repeats": 3}])
        mgr.add(str(tmp_path / "b"))
        mgr.set_repeats(1, 4)
        mgr.sort("count_desc")
        configs = ({"TRAINING_MODE": "Anima DiT"}, {"PREDICTION_TYPE": "rectified_flow"},
                   {"TRAINING_MODE": "SDXL"})
        snapshot = [mgr.get_config(), mgr.total_with_repeats(),
                    [mod.cache_folder_names(c) for c in configs],
                    [str(p.relative_to(tmp_path)) for p in mod.list_images(tmp_path / "a")]]
        cache = tmp_path / "b" / ".precomputed_embeddings_cache_standard_sdxl"
        cache.mkdir(exist_ok=True)
        snapshot.append([Path(p).name for p in mgr.clear_cache(
            next(i for i, e in enumerate(mgr.get_config()) if e["path"].endswith("b")),
            configs[2])])
        mgr.remove([0])
        snapshot.append(mgr.get_config())
        states.append(json.dumps(snapshot, default=str))
    assert states[0] == states[1]
    assert asdict(port_theme.THEME) == asdict(jax_theme.THEME)
    for overrides in ({"accent": "#123456", "bogus": "#fff"}, {"surface": "not a colour"},
                      {"text": "white", "danger": "abcdef"}):
        assert (asdict(port_theme.THEME.with_overrides(overrides))
                == asdict(jax_theme.THEME.with_overrides(overrides)))
    for mod, name in ((port_theme, "port"), (jax_theme, "jax")):
        (tmp_path / name).mkdir()
        mod.GuiState(str(tmp_path / name)).save(last_config="preset.json",
                                                theme_colors={"accent": "#010203"})
    assert ((tmp_path / "port" / "gui_state.json").read_text()
            == (tmp_path / "jax" / "gui_state.json").read_text())


# --------------------------------------------------------------------------
# The app launches the port's CLIs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,cli", [("SDXL", "train_sdxl"), ("Anima DiT", "train_anima"),
                                      ("anima", "train_anima")])
def test_app_launches_the_port_cli_by_module(mode, cli, tmp_path):
    """The app's command for a mode: ``python -u -m <the port's CLI>
    --config <preset>``, never a root script; ``start_training`` launches
    it through ``launch_trainer(module=True)`` and logs the command."""
    cmd = port_app.trainer_command(mode, tmp_path / "p.json")
    assert cmd == [sys.executable, "-u", "-m", f"aozora_sdxl_training_tpu_torch.cli.{cli}",
                   "--config", str(tmp_path / "p.json")]
    assert not any(part.endswith(("train.py", "train_anima.py")) for part in cmd)
    source = inspect.getsource(port_app.TrainingApp.start_training)
    assert "trainer_module(" in source and "module=True" in source
    assert "train.py" not in source and "train_anima.py" not in source


def test_process_runner_launches_a_port_module_from_any_directory(tmp_path, monkeypatch):
    """``launch_trainer(module=True)`` puts the package's root on
    PYTHONPATH, so ``-m`` finds the port from a working directory outside
    the repo: the port's SDXL CLI starts there and, with no card and
    without ``AOZORA_PLATFORM=cpu``, refuses the run with its own message
    (exit 1). The launch has a timeout; the process group is killed."""
    monkeypatch.delenv("AOZORA_PLATFORM", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    got, codes = [], []
    runner = port_runner.launch_trainer(
        "aozora_sdxl_training_tpu_torch.cli.train_sdxl", tmp_path / "missing.json",
        module=True, cwd=tmp_path, on_line=got.append, on_exit=codes.append)
    try:
        code = runner.wait(timeout=LAUNCH_TIMEOUT_S)
    finally:
        runner.stop(grace_seconds=1.0)
    runner._thread.join(timeout=LAUNCH_TIMEOUT_S)
    assert runner.args[2:4] == ["-m", "aozora_sdxl_training_tpu_torch.cli.train_sdxl"]
    assert code == 1 and codes == [1], "\n".join(got)
    assert any("AOZORA_PLATFORM=cpu" in line for line in got), "\n".join(got)


def test_main_without_a_display_exits_naming_the_port_cli(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(SystemExit) as exc:
        port_app.main([])
    assert "aozora_sdxl_training_tpu_torch.cli.train_sdxl" in str(exc.value)
    assert "TPU" not in str(exc.value)
