"""PyTorch port: the memory planner against the JAX package's.

Both planners take the same inputs (element counts, buckets, GA, dtypes,
budget) and must make the same plan: every ``MemoryPlan`` field equal (a
dtype compared by name: torch's and jnp's spell them alike), the same
selection trace, and the same ``describe_plan`` lines. Pure Python on
both sides: no jit, no device.
"""

import contextlib
import io
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.models.sdxl.arch import SDXL_BASE, param_shapes
from aozora_sdxl_training_tpu.train import memory_policy as jax_mp
from aozora_sdxl_training_tpu_torch.train import memory_policy as port_mp
from aozora_sdxl_training_tpu_torch.train.train_step import split_trainable

GB = 1024 ** 3
BUDGETS = (12, 16, 24, 40, 80, None)
MOMENTS = {"bf16": (jnp.bfloat16, torch.bfloat16),
           "fp32": (jnp.float32, torch.float32),
           "int8": ("int8_blockwise", "int8_blockwise")}


def _counts(sizes: dict, exclude) -> tuple[int, int]:
    trainable, _ = split_trainable(sizes, exclude)
    t = sum(trainable.values())
    return t, sum(sizes.values()) - t


# SDXL_BASE with the default preset's frozen conv1/conv2 and with nothing
# frozen; ANIMA_BASE whole and with the t_embedder frozen
SDXL_SIZES = {n: int(np.prod(s)) for n, (s, _) in param_shapes(SDXL_BASE).items()}
ANIMA_SIZES = {n: int(np.prod(s)) for n, s in jax_dit.param_shapes(jax_dit.ANIMA_BASE).items()}
COUNTS = {"sdxl": [_counts(SDXL_SIZES, ["conv1", "conv2"]), _counts(SDXL_SIZES, [])],
          "anima": [_counts(ANIMA_SIZES, []), _counts(ANIMA_SIZES, ["t_embedder"])]}
# largest bucket in latent pixels (SDXL) or DiT tokens (Anima): 768px,
# 1024px, 1536px
SDXL_LATPIX = (96 * 96, 128 * 128, 192 * 192)
ANIMA_TOKENS = (48 * 48, 64 * 64, 96 * 96)


def _same(jax_plan, port_plan):
    for field in jax_plan.__dataclass_fields__:
        want, got = getattr(jax_plan, field), getattr(port_plan, field)
        if field in ("master_dtype", "frozen_dtype", "accum_dtype", "moment_dtype"):
            want = want if want is None or isinstance(want, str) else jnp.dtype(want).name
            got = got if got is None or isinstance(got, str) else port_mp.dtype_name(got)
        assert got == want, (field, got, want)
    assert port_mp.describe_plan(port_plan, verbose=True) == \
        jax_mp.describe_plan(jax_plan, verbose=True)


@pytest.mark.parametrize("budget", BUDGETS, ids=lambda b: f"{b}GB" if b else "unbounded")
@pytest.mark.parametrize("model", ["sdxl", "anima"])
def test_plans_match_jax(model, budget, monkeypatch):
    """Over element counts, GA 1 and 4, masters auto/float32/bfloat16,
    moments bf16/fp32/int8 and three bucket sizes (and, for SDXL, the
    attention preference and a pinned remat mode; for Anima the three
    checkpointing modes), at one budget."""
    monkeypatch.delenv("AOZORA_LOWMEM_RUNG", raising=False)
    budget_bytes = None if budget is None else int(budget * GB)
    n = 0
    out = io.StringIO()
    for (t, f), ga, master, moment in itertools.product(
            COUNTS[model], (1, 4), ("auto", "float32", "bfloat16"), MOMENTS):
        jm, pm = MOMENTS[moment]
        common = dict(trainable_elems=t, frozen_elems=f, batch_per_device=1,
                      ga_steps=ga, budget_bytes=budget_bytes, master_override=master)
        if model == "sdxl":
            extra = itertools.product(SDXL_LATPIX, ("flash", "xla"),
                                      (None, True, "dots_no_logits_hires"))
            cases = [(dict(max_latent_pixels=lp, attn_pref=attn, remat_override=pin),
                      jax_mp.plan_sdxl_training, port_mp.plan_sdxl_training)
                     for lp, attn, pin in extra]
        else:
            cases = [(dict(tokens=tok, remat=remat),
                      jax_mp.plan_anima_training, port_mp.plan_anima_training)
                     for tok, remat in itertools.product(
                         ANIMA_TOKENS, (True, "conservative", False))]
        for kw, jax_plan, port_plan in cases:
            with contextlib.redirect_stdout(out):
                want = jax_plan(requested_moment_dtype=jm, **common, **kw)
                got = port_plan(requested_moment_dtype=pm, **common, **kw)
            _same(want, got)
            n += 1
    assert n == 2 * 2 * 3 * 3 * (18 if model == "sdxl" else 9)


@pytest.mark.parametrize("rung", ["two_pass", "moments_host"])
def test_forced_rung_and_device_budget(monkeypatch, rung):
    """``AOZORA_LOWMEM_RUNG`` pins the same rung in both planners at GA 1;
    off the card the port's budget is None (unconstrained), as JAX's is
    off the TPU."""
    monkeypatch.setenv("AOZORA_LOWMEM_RUNG", rung)
    t, f = COUNTS["sdxl"][0]
    kw = dict(trainable_elems=t, frozen_elems=f, batch_per_device=1,
              max_latent_pixels=128 * 128, ga_steps=1, budget_bytes=int(80 * GB))
    want = jax_mp.plan_sdxl_training(**kw)
    got = port_mp.plan_sdxl_training(**kw)
    _same(want, got)
    assert getattr(got, rung) and got.master_dtype == torch.bfloat16
    assert port_mp.device_budget_bytes("cpu") is None


def test_fast_backward_knobs_follow_jax(monkeypatch):
    """The JAX package's ``AOZORA_FLASH_MIN_KV`` for a plan with and without
    the fast backward (each package run alone), the two XLA-rewrite knobs
    left unset by the port, and a user's own pin wins."""
    knobs = ("AOZORA_CONV_BWD", "AOZORA_FUSED_QKV", "AOZORA_FLASH_MIN_KV")
    monkeypatch.setattr(jax_mp, "_APPLIED_KNOBS", {})
    monkeypatch.setattr(port_mp, "_APPLIED_KNOBS", {})
    t, f = COUNTS["sdxl"][0]
    kw = dict(trainable_elems=t, frozen_elems=f, batch_per_device=1,
              max_latent_pixels=128 * 128, ga_steps=1, master_override="bfloat16")
    for budget, fast in ((None, True), (int(16 * GB), False)):
        plans = (jax_mp.plan_sdxl_training(budget_bytes=budget, **kw),
                 port_mp.plan_sdxl_training(budget_bytes=budget, **kw))
        seen = []
        for mod, plan in zip((jax_mp, port_mp), plans):
            assert plan.fast_backward is fast
            for key in knobs:
                monkeypatch.delenv(key, raising=False)
            mod.apply_fast_backward_knobs(plan)
            seen.append({k: os.environ.get(k) for k in knobs})
        assert seen[1] == {"AOZORA_CONV_BWD": None, "AOZORA_FUSED_QKV": None,
                           "AOZORA_FLASH_MIN_KV": seen[0]["AOZORA_FLASH_MIN_KV"]}
        # a value the port set for an earlier plan is not a pin
        port_mp.apply_fast_backward_knobs(plans[1])
        assert os.environ["AOZORA_FLASH_MIN_KV"] == seen[0]["AOZORA_FLASH_MIN_KV"]
    port_mp.apply_fast_backward_knobs(
        port_mp.plan_sdxl_training(budget_bytes=None, **kw))
    assert os.environ["AOZORA_FLASH_MIN_KV"] == "1024"
    monkeypatch.setenv("AOZORA_FLASH_MIN_KV", "4096")
    port_mp.apply_fast_backward_knobs(plans[1])
    assert os.environ["AOZORA_FLASH_MIN_KV"] == "4096"


@contextlib.contextmanager
def recorded_plans():
    """While open, the port's two planners record the keyword arguments of
    each call (``{"sdxl" | "anima": [kwargs, ...]}``); ``jax_plan_lines``
    makes the JAX planner's ``describe_plan`` lines from them."""
    calls = {"sdxl": [], "anima": []}
    real = {name: getattr(port_mp, f"plan_{name}_training") for name in calls}

    def recording(name):
        def plan(**kwargs):
            calls[name].append(kwargs)
            return real[name](**kwargs)
        return plan

    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(port_mp, f"plan_{name}_training", recording(name))
        yield calls


def jax_plan_lines(name: str, kwargs: dict) -> list[str]:
    """The JAX planner's ``describe_plan`` lines for a port planner call's
    arguments (torch dtypes as the jnp dtypes of the same names)."""
    conv = {k: (jnp.dtype(str(v).replace("torch.", "")) if isinstance(v, torch.dtype) else v)
            for k, v in kwargs.items()}
    plan = getattr(jax_mp, f"plan_{name}_training")(**conv)
    return jax_mp.describe_plan(plan).splitlines()
