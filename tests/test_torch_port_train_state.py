"""PyTorch port: int8 blockwise moments and the training-state file against
the JAX package.

* The int8 primitives (256-element blocks over the flat order, absmax / 127
  scales, the second moment in the sqrt domain) give the JAX package's
  codes and scales bit for bit on tensors whose sizes are not multiples of
  256.
* A 5-step ``int8_blockwise`` AdamW trajectory over a conv, a linear, a
  1-D tensor and one tensor under ``min_8bit_size`` (fp32 moments), from
  the same params and grads: the port keeps its params in torch layout and
  its codes in the JAX layout, and matches the JAX update run eagerly bit
  for bit, and the jitted JAX update (which XLA fuses) code for code.
* A state file with bf16, fp32 and int8 moments written by either package
  loads in the other: every moment bit for bit after the layout map, the
  metadata equal, and the two files byte for byte the same.
* ``check_resume_global_batch`` refuses a mismatch, passes a match and
  warns on a state that predates the guard.
"""

import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.ckpt import train_state as jax_ts
from aozora_sdxl_training_tpu.opt import adamw as jax_adamw
from aozora_sdxl_training_tpu_torch.ckpt import train_state as port_ts
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.models.sdxl import conversion as port_conv
from aozora_sdxl_training_tpu_torch.opt import adamw as port_adamw

from tests.test_torch_port_trainer import one_thread


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


LAYOUTS = {
    "sdxl": port_adamw.Layout(port_conv.to_jax_layout, port_conv.from_jax_layout),
    "anima": port_adamw.Layout(port_dit.to_jax_layout, port_dit.from_jax_layout),
}
SDXL = port_adamw.Layout(port_conv.to_jax_layout, port_conv.from_jax_layout)


def _heavy_tailed(rng, shape):
    """Values over several orders of magnitude, as moments are."""
    return (rng.normal(size=shape) * np.exp(rng.normal(size=shape) * 3)).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 3, 7, 13), (37, 29), (1000,)])
@pytest.mark.parametrize("moment", ["first", "second"])
def test_int8_primitives_match_jax(shape, moment):
    x = _heavy_tailed(np.random.default_rng(0), shape)
    if moment == "first":
        quant, deq = "quantize_moment_int8", "dequantize_moment_int8"
    else:
        x = np.abs(x)
        quant, deq = "quantize_second_moment_int8", "dequantize_second_moment_int8"
    want_codes, want_scales = getattr(jax_adamw, quant)(jnp.asarray(x))
    codes, scales = getattr(port_adamw, quant)(torch.from_numpy(x))
    assert codes.dtype == torch.int8 and tuple(codes.shape) == shape
    assert scales.shape == (-(-x.size // 256),)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))
    np.testing.assert_array_equal(
        getattr(port_adamw, deq)(codes, scales).numpy(),
        np.asarray(getattr(jax_adamw, deq)(want_codes, want_scales)))


TRAJECTORY = {"down.0.conv.weight": (3, 3, 5, 7), "down.0.proj.weight": (20, 30),
              "down.0.norm.weight": (300,), "down.0.conv.bias": (33,)}


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_int8_adamw_trajectory_matches_jax(jit):
    """5 steps, debias 0.3, weight decay, min_8bit_size 64 (the 33-element
    bias keeps fp32 moments). Run eagerly, the JAX update is matched bit for
    bit: params, fp32 moments, codes and scales. Jitted, XLA fuses the
    update's multiply-adds, which moves params, fp32 moments and scales by
    a few fp32 ulps (here at most 2.3e-7 of a tensor's largest magnitude):
    codes identical, the rest within 1e-6 of each tensor's largest
    magnitude."""
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in TRAJECTORY.items()}
    jcfg = jax_adamw.AdamWConfig(debias_strength=0.3, weight_decay=0.01,
                                 momentum_dtype="int8_blockwise", min_8bit_size=64)
    pcfg = port_adamw.AdamWConfig.from_params_dict(
        {"debias_strength": 0.3, "weight_decay": 0.01, "momentum_dtype": "int8",
         "min_8bit_size": 64})
    assert pcfg.int8_state and pcfg.int8_for(64) and not pcfg.int8_for(33)

    def port_layout(arrays):
        return {k: SDXL.from_jax(k, torch.from_numpy(np.array(v))).contiguous()
                for k, v in arrays.items()}

    def same(got, want, what):
        want = np.asarray(want)
        if jit:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(), err_msg=what)
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jax_adamw.init_state(jp, jcfg)
    pp = port_layout(p0)
    pstate = port_adamw.init_state(pp, pcfg, SDXL)
    update = functools.partial(jax_adamw.apply_updates, cfg=jcfg)
    if jit:
        update = jax.jit(update)
    for step in range(5):
        g = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
             for k, s in TRAJECTORY.items()}
        lr = 1e-3 * (step + 1)
        jp, jstate = update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate, lr=lr)
        port_adamw.apply_updates(pp, port_layout(g), pstate, pcfg, lr=lr)
    assert pstate.step == int(jstate.step) == 5
    for name in TRAJECTORY:
        same(SDXL.to_jax(name, pp[name]).numpy(), jp[name], name)
        for field in ("exp_avg", "exp_avg_sq"):
            got, want = getattr(pstate, field)[name], getattr(jstate, field)[name]
            if name.endswith(".bias"):
                assert got.dtype == torch.float32
                same(got.numpy(), want, f"{field} of {name}")
                continue
            assert got[0].shape == want[0].shape, name   # the JAX layout's
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                          err_msg=f"{field} codes of {name}")
            same(got[1].numpy(), want[1], f"{field} scales of {name}")


# --------------------------------------------------------------------------
# The training-state file across packages
# --------------------------------------------------------------------------

NAMES = {
    "sdxl": {"conv_in.weight": (5, 4, 3, 3), "time_embedding.linear_1.weight": (24, 40),
             "conv_in.bias": (5,), "down_blocks.0.resnets.0.conv1.weight": (9, 5, 3, 3)},
    "anima": {"blocks.0.self_attn.q_proj.weight": (24, 40), "llm_adapter.embed.weight": (30, 16),
              "blocks.0.self_attn.q_norm.weight": (8,), "final_layer.linear.weight": (12, 24)},
}
META = dict(global_step=3, micro_step=6, sampler_seed=11, sampler_epoch=0,
            timestep_sampler_state={"pool_index": 6},
            extra={"schedule_global_batch": 2})


def _states(model):
    """The same moments for both packages: bf16, fp32 and int8 (codes in the
    JAX layout) by turns; the port's float moments in its own layout."""
    layout = LAYOUTS[model]
    rng = np.random.default_rng(7)
    jax_m, port_m = {}, {}
    for field in ("m", "v"):
        jax_m[field], port_m[field] = {}, {}
        for i, (name, torch_shape) in enumerate(NAMES[model].items()):
            jax_shape = tuple(layout.to_jax(name, torch.empty(torch_shape)).shape)
            x = _heavy_tailed(rng, jax_shape)
            kind = ("bf16", "fp32", "int8")[(i + (field == "v")) % 3]
            if kind == "int8":
                codes, scales = port_adamw.quantize_moment_int8(torch.from_numpy(x))
                jax_m[field][name] = (codes.numpy(), scales.numpy())
                port_m[field][name] = (codes, scales)
                continue
            arr = x.astype(ml_dtypes.bfloat16) if kind == "bf16" else x
            jax_m[field][name] = arr
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if kind == "bf16" else torch.from_numpy(arr))
            port_m[field][name] = layout.from_jax(name, t).contiguous()
            assert tuple(port_m[field][name].shape) == torch_shape
    jstate = jax_adamw.AdamWState(step=np.asarray(3, np.int32),
                                  exp_avg=jax_m["m"], exp_avg_sq=jax_m["v"])
    pstate = port_adamw.AdamWState(step=3, exp_avg=port_m["m"], exp_avg_sq=port_m["v"],
                                   layout=layout)
    return jstate, pstate


def _bits(t):
    """The bytes of a tensor or array, in C order."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(t).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("model", ["sdxl", "anima"])
def test_state_file_reads_across_packages(tmp_path, model):
    jstate, pstate = _states(model)
    jax_ts.save_train_state(tmp_path / "jax.safetensors", opt_state=jstate, **META)
    port_ts.save_train_state(tmp_path / "port.safetensors", opt_state=pstate, **META)
    assert (tmp_path / "jax.safetensors").read_bytes() == \
        (tmp_path / "port.safetensors").read_bytes()

    layout = LAYOUTS[model]
    meta, got = port_ts.load_train_state(tmp_path / "jax.safetensors", layout)
    jax_meta, jax_got = jax_ts.load_train_state(tmp_path / "port.safetensors")
    want_meta = {**{k: v for k, v in META.items() if k != "extra"}, **META["extra"]}
    assert meta == jax_meta == json.loads(json.dumps(want_meta))
    assert got.step == 3 and int(jax_got.step) == 3 and jax_got.step.dtype == np.int32
    for field in ("exp_avg", "exp_avg_sq"):
        want, port_got, jax_read = (getattr(s, field) for s in (jstate, got, jax_got))
        assert port_got.keys() == jax_read.keys() == want.keys()
        for name, w in want.items():
            if isinstance(w, tuple):
                for a, b, c in zip(port_got[name], jax_read[name], w):
                    assert a.dtype == torch.from_numpy(c).dtype
                    np.testing.assert_array_equal(_bits(a), _bits(c), err_msg=name)
                    np.testing.assert_array_equal(_bits(b), _bits(c), err_msg=name)
                continue
            assert tuple(port_got[name].shape) == NAMES[model][name]
            np.testing.assert_array_equal(
                _bits(layout.to_jax(name, port_got[name]).contiguous()), _bits(w),
                err_msg=name)
            np.testing.assert_array_equal(_bits(jax_read[name]), _bits(w), err_msg=name)


def test_restored_state_checks_each_moment_against_the_optimizer():
    """``restored_state`` moves the host moments in the storage that
    ``init_state`` would give them and refuses a moment of another kind."""
    _, pstate = _states("sdxl")
    params = {n: torch.zeros(s) for n, s in NAMES["sdxl"].items()}
    int8 = port_adamw.AdamWConfig(momentum_dtype="int8_blockwise", min_8bit_size=1)
    with pytest.raises(ValueError, match="does not fit the optimizer"):
        port_adamw.restored_state(pstate, params, int8)
    fresh = port_adamw.init_state(params, int8, SDXL)
    for name, (codes, _) in fresh.exp_avg.items():
        assert tuple(codes.shape) == tuple(SDXL.to_jax(name, params[name]).shape)
    back = port_adamw.restored_state(fresh, params, int8)
    assert back.step == 0 and back.layout is SDXL
    fp32 = port_adamw.AdamWConfig(momentum_dtype=torch.float32)
    plain = port_adamw.init_state(params, port_adamw.AdamWConfig(), SDXL)
    cast = port_adamw.restored_state(plain, params, fp32)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in cast.exp_avg.values())


def test_check_resume_global_batch(capsys):
    port_ts.check_resume_global_batch({"schedule_global_batch": 2}, 2)
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="global batch of 2.*implies 4"):
        port_ts.check_resume_global_batch({"schedule_global_batch": 2}, 4)
    port_ts.check_resume_global_batch({"global_step": 3}, 4)
    out = capsys.readouterr().out
    jax_ts.check_resume_global_batch({"global_step": 3}, 4)
    assert "predates the schedule-global-batch guard" in out
    assert out == capsys.readouterr().out
