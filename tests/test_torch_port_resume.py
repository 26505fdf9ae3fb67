"""PyTorch port: ``paged_adamw_8bit`` (int8 blockwise moments) through the
SDXL training CLI, saved and resumed.

On the TINY checkpoint and cache of ``tests/test_torch_port_trainer.py``
(CPU, ``AOZORA_PLATFORM=cpu``), the port trains 4 micro steps at GA 2 with
``OPTIMIZER_TYPE`` paged_adamw_8bit and saves at each optimizer step, then
resumes from optimizer step 1's files. The state file holds int8 codes in
the JAX layout with their ``@scales`` and fp32 moments for the tensors
under ``min_8bit_size``; the resumed trainer restores exactly the codes and
scales that were saved, and its losses are the unbroken run's.
"""

import re
from unittest import mock

import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import read_header
from aozora_sdxl_training_tpu_torch.ckpt.train_state import load_train_state
from aozora_sdxl_training_tpu_torch.models.sdxl import conversion
from aozora_sdxl_training_tpu_torch.opt import adamw
import aozora_sdxl_training_tpu_torch.train.reporter as port_reporter

from tests.test_torch_port_trainer import (GA, STEPS, _build_env, _flat, _recording,
                                           _resume_flat, _run_port_cli, one_thread)

INT8 = {"OPTIMIZER_TYPE": "paged_adamw_8bit", "SAVE_EVERY_N_STEPS": 1}


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


def test_int8_moments_save_and_resume(tmp_path):
    _build_env(tmp_path)
    losses, restored = [], []
    original_restore = adamw.restored_state

    def restore(*args, **kwargs):
        # a copy as restored: training then updates the moments in place
        state = original_restore(*args, **kwargs)
        restored.append({field: {n: tuple(t.clone() for t in (m if isinstance(m, tuple) else (m,)))
                                 for n, m in getattr(state, field).items()}
                         for field in ("exp_avg", "exp_avg_sq")})
        return state

    with pytest.MonkeyPatch.context() as mp, \
            mock.patch("aozora_sdxl_training_tpu_torch.train.trainer."
                       "check_if_caching_needed", return_value=False):
        mp.setenv("AOZORA_PLATFORM", "cpu")
        mp.setattr(port_reporter.MetricsReporter, "log_step",
                   _recording(port_reporter.MetricsReporter, losses))
        mp.setattr(adamw, "restored_state", restore)
        unbroken = _run_port_cli(tmp_path, "int8", _flat(tmp_path, "out_port", **INT8))
        resumed = _run_port_cli(tmp_path, "int8_resumed", {
            **_resume_flat(tmp_path, "out_resumed", "out_port"), **INT8})
    assert "Min 8-bit size:      4096" in unbroken

    state_file = tmp_path / "out_port" / "run_training_state_step_1.safetensors"
    header = read_header(state_file)
    codes = {k: v for k, v in header.items() if v["dtype"] == "I8"}
    assert codes and all(f"{k}@scales" in header for k in codes)
    assert {v["dtype"] for v in header.values()} == {"I8", "F32", "I32"}
    meta, saved = load_train_state(state_file, adamw.Layout(conversion.to_jax_layout,
                                                            conversion.from_jax_layout))
    assert meta["micro_step"] == GA and saved.step == 1
    n_int8 = n_fp32 = 0
    for name, m in saved.exp_avg.items():
        if not isinstance(m, tuple):
            assert m.dtype == torch.float32 and m.numel() < 4096, name
            n_fp32 += 1
            continue
        n_int8 += 1
        jax_shape = header[f"m.{name}"]["shape"]
        assert list(m[0].shape) == jax_shape and m[1].numel() == -(-m[0].numel() // 256)
        if len(jax_shape) == 4:        # HWIO: kernel height and width first
            assert jax_shape[:2] == [3, 3] or jax_shape[:2] == [1, 1], name
    assert n_int8 and n_fp32

    # the resumed trainer holds the saved codes and scales, bit for bit
    (got,) = restored
    for field in ("exp_avg", "exp_avg_sq"):
        for name, want in getattr(saved, field).items():
            for a, b in zip(got[field][name], want if isinstance(want, tuple) else (want,)):
                assert a.dtype == b.dtype and torch.equal(a, b.contiguous()), name

    assert len(losses) == STEPS + STEPS - GA and all(np.isfinite(losses))
    np.testing.assert_allclose(losses[STEPS:], losses[GA:STEPS], rtol=1e-2)
    assert "INFO: Restored optimizer state from resume checkpoint." in resumed
    assert [int(m) for m in re.findall(r"--- Optimizer Step: (\d+)", resumed)] == [2]
