"""Memory-aware training-policy selection (remat / attention / state dtypes).

Counterpart of ``aozora_sdxl_training_tpu/train/memory_policy.py``: given
the model size, the trainable split, the largest bucket shape and the
device's memory, pick the fastest (attention, remat) configuration and the
cheapest state layout that still fits. Both packages make the same plan
from the same inputs: the coefficients, ladders and candidate order are
the JAX package's, and ``describe_plan`` prints the same lines.

Two stacked ladders:

* **state ladder** (quality first): fp32 masters + an fp32 accumulation
  tree -> fp32 masters + the fused GA=1 step -> bf16 masters (the
  reference's own training precision; the update runs in fp32 scratch)
  with a bf16 accumulation tree or the fused step -> additionally int8
  blockwise moments when the requested moment dtype cannot fit (printed;
  the update math is unchanged, storage only).
* **speed ladder** (per attention impl, fastest first): no remat, the
  ``dots_no_logits_hires`` tiers, ``dots_no_logits``, full remat.

The activation and state coefficients were calibrated on the JAX
package's TPU and are not recalibrated here: on the card they are an
estimate whose error ``chip_smoke.py``'s ``plan`` phase records beside the
measured peak. ``device_budget_bytes`` is the card's total memory.

``plan_sdxl_training`` returns a :class:`MemoryPlan`; the trainer applies
it wholesale. Explicit knobs still win: ``AOZORA_SDXL_REMAT`` pins the
remat mode, ``MASTER_DTYPE`` (config) pins the master precision.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch

MB = 1024 * 1024
GB = 1024 * MB

# Estimated activation+workspace bytes per (batch x latent-pixel), bf16
# compute, full SDXL-width UNet: the JAX package's coefficients
# (deliberately high), kept so that both packages plan alike.
_ACT_BYTES_PER_LATPIX = {
    ("flash", False): 0.55 * MB,
    ("xla", False): 0.85 * MB,
    ("flash", "dots_no_logits_hires"): 0.30 * MB,
    ("xla", "dots_no_logits_hires"): 0.33 * MB,
    ("flash", "dots_no_logits"): 0.34 * MB,
    ("xla", "dots_no_logits"): 0.34 * MB,
    ("flash", "dots"): 0.66 * MB,
    ("xla", "dots"): 0.70 * MB,
    ("flash", True): 0.05 * MB,
    ("xla", True): 0.05 * MB,
    # 3-tier: the biggest levels full remat, mid levels dots_no_logits,
    # small levels resident
    ("flash", "dots_no_logits_hires", "fulltop"): 0.27 * MB,
    ("xla", "dots_no_logits_hires", "fulltop"): 0.30 * MB,
}

# Speed ladders: fastest-first (attn, remat[, tier]) entries. Flash is
# never paired with the plain dots policies. The "fulltop" tier (the top
# level fully rematerialized) sits between plain hires and dots_no_logits.
_LADDER_FLASH = [
    ("flash", False, None),
    ("flash", "dots_no_logits_hires", None),
    ("flash", "dots_no_logits_hires", "fulltop"),
    ("xla", "dots_no_logits", None),
    ("flash", True, None),
]
_LADDER_XLA = [
    ("xla", False, None),
    ("xla", "dots_no_logits_hires", None),
    ("xla", "dots_no_logits_hires", "fulltop"),
    ("xla", "dots_no_logits", None),
    ("xla", True, None),
]

# Backward workspace of the JAX package's fast-backward rewrites (GEMM conv
# backward + fused QKV), per latent pixel: it gates them on a low-memory
# rung (``_gate_fast_backward``).
_FAST_BWD_BYTES_PER_LATPIX = 0.31 * MB

# Reserved headroom: workspace, batch buffers (double-buffered prefetch),
# preview/save transients, fragmentation slack.
_RESERVE_BYTES = int(0.4 * GB)
# multiplicative slack on the state accounting
_STATE_SLACK = 1.02


@dataclass(frozen=True)
class MemoryPlan:
    master_dtype: Any          # trainable master-weight dtype
    frozen_dtype: Any          # frozen-parameter storage dtype
    accum_dtype: Any | None    # grad-accum tree dtype; None = fused step
    fused_apply: bool          # GA folded into the micro step (GA == 1)
    moment_dtype: Any          # resolved moment storage (may downgrade)
    attn_impl: str
    remat: Any                 # False | True | mode string
    est_bytes: int             # peak estimate at the chosen config
    budget_bytes: int
    reason: str                # human-readable selection trace
    moments_host: bool = False  # optimizer moments parked in pinned_host
    two_pass: bool = False      # norm pass + recompute-update pass (GA=1)
    # (hires_tokens, full_tokens) for "*_hires" remat modes; None keeps the
    # model's env-tunable defaults (no full-remat tier)
    remat_thresholds: tuple | None = None
    # the JAX package's backward rewrites (GEMM conv backward + fused QKV)
    # allowed? False when their workspace does not fit next to a
    # low-memory state rung; ``apply_fast_backward_knobs`` then pins the
    # legacy knobs
    fast_backward: bool = True
    # multi-device weight layout (bf16 compute copies gathered once per
    # micro step, or dp-sharded); irrelevant on one device
    gather_once: bool = True

    @property
    def low_memory(self) -> bool:
        return self.master_dtype == torch.bfloat16


def dtype_name(dtype) -> str:
    """A dtype's name as the JAX package spells it ("float32",
    "bfloat16"): the plans' traces and ``describe_plan`` print it."""
    return str(dtype).removeprefix("torch.")


def dtype_bytes(dtype) -> float:
    if dtype == "int8_blockwise":
        return 1.0 + 4.0 / 256.0          # int8 codes + fp32 block scales
    return dtype.itemsize


def device_budget_bytes(device=None) -> int | None:
    """The card's total memory, or None off CUDA (the CPU: treat as
    unconstrained, as the JAX package does off the TPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def state_bytes(trainable_elems: int, frozen_elems: int, *,
                master_dtype, frozen_dtype, accum_dtype, moment_dtype,
                dp_shard: int = 1, moments_host: bool = False,
                fused: bool = False, two_pass: bool = False,
                gather_once: bool = True) -> dict[str, int]:
    """Per-device resident + transient state accounting, term for term
    the JAX package's (its docstring and comments give each term's
    derivation; the terms were calibrated there, not on the card).

    Under FSDP the master/moment/accum trees shard over ``dp_shard``.
    ``moments_host=True`` parks the moment trees in host memory (a
    streaming buffer, not device residency). ``fused=True`` adds the fused
    step's fragmentation and update transients.
    """
    shard = max(int(dp_shard), 1)
    t, f = int(trainable_elems), int(frozen_elems)
    master = t * dtype_bytes(master_dtype) / shard
    frozen = f * dtype_bytes(frozen_dtype) / shard
    moments = 2 * t * dtype_bytes(moment_dtype) / shard
    accum = t * dtype_bytes(accum_dtype) / shard if accum_dtype else 0
    if two_pass:
        # each gradient dies at its only consumer (square-sum reduction in
        # pass 1, its parameter's update in pass 2): per-tensor scratch only
        grads = int(0.5 * GB)
    else:
        # backward produces a full gradient tree in the master dtype; with
        # grad clipping every leaf is alive until the global norm is known
        grads = t * dtype_bytes(master_dtype) / shard
    if moments_host:
        # moments stream through a bounded staging window, not residency
        hbm_moments = int(0.5 * GB) if moments else 0
    else:
        hbm_moments = moments
    # gather-once compute replicas (train_step._compute_sharding): under
    # FSDP every >=2-D weight's bf16 compute copy is pinned dp-gathered for
    # the whole micro-step — one all-gather per weight per step and fully
    # local consumers, at the cost of the full bf16 weight tree resident
    # next to the activations (conservative: ignores tp sharding of the
    # compute copy).
    compute_replicas = 2 * (t + f) if (shard > 1 and gather_once) else 0
    resident = master + frozen + hbm_moments + accum + compute_replicas
    peak = (resident + grads) * _STATE_SLACK
    if two_pass:
        # fp32 update scratch (m/v/p per tensor) in pass 2 + slack
        peak += int(1.0 * GB)
    elif fused:
        # fragmentation among the gradient buffers + fp32 update scratch
        peak += 0.16 * grads + int(0.6 * GB)
        if moment_dtype == "int8_blockwise" and not moments_host:
            # the JAX package's compiler may decode every int8 moment ahead
            # of the backward: up to 2x trainable of fp32 scratch. The
            # port's eager step decodes one tensor at a time; the term is
            # kept so that both packages make the same plan.
            peak += 2 * t * 4 / shard
    return {"master": int(master), "frozen": int(frozen),
            "moments": int(moments), "accum": int(accum),
            "grads_transient": int(grads),
            "resident": int(resident),
            "peak_state": int(peak)}


def _gate_fast_backward(plan: MemoryPlan, batch: int,
                        latent_pixels: int,
                        ws_bytes_per_unit: float | None = None
                        ) -> MemoryPlan:
    """Disable the fast-backward rewrites on a selected plan when their
    workspace does not fit next to a single-device low-memory state rung
    (``_FAST_BWD_BYTES_PER_LATPIX``). Rung selection is untouched."""
    if not (plan.low_memory and plan.fused_apply and plan.budget_bytes):
        return plan
    coeff = (ws_bytes_per_unit if ws_bytes_per_unit is not None
             else _FAST_BWD_BYTES_PER_LATPIX)
    ws = int(coeff * batch * latent_pixels)
    if plan.est_bytes + ws <= plan.budget_bytes:
        return plan
    from dataclasses import replace
    note = (f"fast-backward rewrites gated: est {plan.est_bytes / GB:.2f} "
            f"+ workspace {ws / GB:.2f} GB > budget "
            f"{plan.budget_bytes / GB:.2f} GB -> legacy conv backward / "
            "unfused QKV")
    return replace(plan, fast_backward=False,
                   reason=plan.reason + "\n" + note)


# The values this module set, so that a knob it set for an earlier plan (a
# GUI process that runs several trainings, a test suite) is never taken
# for a user's pin.
_APPLIED_KNOBS: dict[str, str] = {}


def apply_fast_backward_knobs(plan: MemoryPlan) -> None:
    """Sets the plan's fast-backward decision into ``AOZORA_FLASH_MIN_KV``
    (``ops/attention.py``: the shortest key sequence that takes the flash
    kernels) with the JAX package's values: 1024 with the fast backward,
    2048 gated. An explicit user pin (a value this module did not set)
    always wins."""
    key, val = "AOZORA_FLASH_MIN_KV", "1024" if plan.fast_backward else "2048"
    current = os.environ.get(key)
    if current is None or current == _APPLIED_KNOBS.get(key):
        os.environ[key] = val
        _APPLIED_KNOBS[key] = val


# Fused-QKV backward workspace for the Anima DiT (bytes per batch x token),
# the JAX package's estimate.
_ANIMA_FAST_BWD_BYTES_PER_TOKEN = 0.25 * MB


def activation_bytes(attn_impl: str, remat, batch: int,
                     latent_pixels: int, tier: str | None = None) -> int:
    key = (attn_impl, remat, tier) if tier else (attn_impl, remat)
    coeff = _ACT_BYTES_PER_LATPIX.get(key)
    if coeff is None:  # unknown combo: assume the worst measured
        coeff = 0.9 * MB
    return int(coeff * batch * latent_pixels)


def _ladder_for(attn_pref: str):
    return _LADDER_FLASH if attn_pref == "flash" else _LADDER_XLA


def _state_candidates(ga_steps: int, master_override,
                      requested_moment_dtype, *,
                      allow_moments_host: bool = False):
    """Quality-first (master, accum, fused, moment, host, two_pass)
    layouts.

    The single-device GA=1 rungs after the plain fused candidates
    (``allow_moments_host`` gates both; their steps are
    ``train_step.make_two_pass_step`` and ``opt/adamw.HostMoments``):

    * **two-pass**: a norm pass, then a recompute-and-update pass; the
      gradient tree never materializes (~2x backward compute).
    * **host moments**: the moment trees live in host memory and stream
      through the update every step (the reference's Raven/Titan CPU
      offload); int8 moments first, since transfer bytes set the step.
    """
    out = []
    if master_override and str(master_override) != "auto":
        masters = [torch.bfloat16 if "bfloat16" in str(master_override)
                   else torch.float32]
    else:
        masters = [torch.float32, torch.bfloat16]
    # Dev/test knob: pin a low-memory rung that an unconstrained budget
    # never picks.
    forced = os.environ.get("AOZORA_LOWMEM_RUNG", "")
    if forced and allow_moments_host and ga_steps == 1:
        if forced == "two_pass":
            return [(torch.bfloat16, None, True, "int8_blockwise", False, True)]
        if forced == "moments_host":
            return [(torch.bfloat16, None, True, "int8_blockwise", True, False)]
    for master in masters:
        accum_opts: list[tuple[Any, bool]] = []
        if master == torch.float32:
            accum_opts.append((torch.float32, False))
            if ga_steps == 1:
                accum_opts.append((None, True))
        else:
            if ga_steps == 1:
                accum_opts.append((None, True))
            accum_opts.append((torch.bfloat16, False))
        moment_opts = [requested_moment_dtype]
        if (master == torch.bfloat16
                and requested_moment_dtype != "int8_blockwise"):
            moment_opts.append("int8_blockwise")
        for accum_dtype, fused in accum_opts:
            for moment in moment_opts:
                out.append((master, accum_dtype, fused, moment, False, False))
    if allow_moments_host and ga_steps == 1 and torch.bfloat16 in masters:
        if requested_moment_dtype != "int8_blockwise":
            out.append((torch.bfloat16, None, True, requested_moment_dtype,
                        False, True))
        out.append((torch.bfloat16, None, True, "int8_blockwise", False, True))
        out.append((torch.bfloat16, None, True, "int8_blockwise", True, False))
        if requested_moment_dtype != "int8_blockwise":
            out.append((torch.bfloat16, None, True, torch.bfloat16, True, False))
    return out


# Anima DiT activation footprints (bytes per batch x token, 2048-wide
# 28-block model, bf16 compute) keyed by the checkpointing mode: the JAX
# package's conservative bounds.
_ANIMA_ACT_BYTES_PER_TOKEN = {
    True: 0.25 * MB,            # Full: recompute each block
    "conservative": 0.60 * MB,  # saves mlp_down + flash (out,lse)
    False: 2.0 * MB,            # no recompute
}


def plan_anima_training(*, trainable_elems: int, frozen_elems: int,
                        batch_per_device: int, tokens: int, ga_steps: int,
                        remat, dp_shard: int = 1,
                        requested_moment_dtype: Any = torch.bfloat16,
                        budget_bytes: int | None = None,
                        master_override: str | None = None) -> MemoryPlan:
    """State-dtype plan for the Anima DiT trainer.

    Unlike the SDXL planner this does NOT choose remat/attention — the
    checkpointing mode is a user-facing reference-parity knob
    (ANIMA_GRADIENT_CHECKPOINTING_MODE); only the master/accum/moment
    layout is selected so full-model 2.09B single-chip training fits.
    """
    act = int(_ANIMA_ACT_BYTES_PER_TOKEN.get(remat, 2.0 * MB)
              * batch_per_device * tokens)
    trace: list[str] = []
    best_fallback = None
    gather_modes = [True, False] if dp_shard > 1 else [True]
    for master, accum_dtype, fused, moment, host, two_pass in _state_candidates(
            ga_steps, master_override, requested_moment_dtype,
            allow_moments_host=(dp_shard == 1)):
        frozen_dtype = torch.bfloat16 if master == torch.bfloat16 else torch.float32
        for g in gather_modes:
            st = state_bytes(trainable_elems, frozen_elems,
                             master_dtype=master, frozen_dtype=frozen_dtype,
                             accum_dtype=accum_dtype, moment_dtype=moment,
                             dp_shard=dp_shard, moments_host=host,
                             fused=fused, two_pass=two_pass, gather_once=g)
            est = st["peak_state"] + act + _RESERVE_BYTES
            fits = budget_bytes is None or est <= budget_bytes
            trace.append(
                f"{dtype_name(master)}-master/"
                f"{'fused' if fused else dtype_name(accum_dtype) + '-accum'}/"
                f"{moment if isinstance(moment, str) else dtype_name(moment)}"
                f"-moments{'@host' if host else ''}"
                f"{'/two-pass' if two_pass else ''}"
                f"{'/gather-once' if g and dp_shard > 1 else ''}: "
                f"{est / GB:.2f} GB "
                f"{'<=' if fits else '>'} {(budget_bytes or 0) / GB:.2f} -> "
                f"{'SELECTED' if fits else 'skip'}")
            plan = MemoryPlan(master_dtype=master, frozen_dtype=frozen_dtype,
                              accum_dtype=accum_dtype, fused_apply=fused,
                              moment_dtype=moment, attn_impl="flash",
                              remat=remat, est_bytes=int(est),
                              budget_bytes=int(budget_bytes or 0),
                              reason="\n".join(trace), moments_host=host,
                              two_pass=two_pass, gather_once=g)
            if fits:
                return _gate_fast_backward(
                    plan, batch_per_device, tokens,
                    ws_bytes_per_unit=_ANIMA_FAST_BWD_BYTES_PER_TOKEN)
            if best_fallback is None or est < best_fallback.est_bytes:
                best_fallback = plan
    print("WARNING: no Anima state layout fits the estimated HBM budget; "
          "attempting the smallest candidate.\n" + "\n".join(trace))
    return _gate_fast_backward(
        best_fallback, batch_per_device, tokens,
        ws_bytes_per_unit=_ANIMA_FAST_BWD_BYTES_PER_TOKEN)


def plan_sdxl_training(*, trainable_elems: int, frozen_elems: int,
                       batch_per_device: int, max_latent_pixels: int,
                       ga_steps: int, dp_shard: int = 1,
                       attn_pref: str = "flash",
                       requested_moment_dtype: Any = torch.bfloat16,
                       budget_bytes: int | None = None,
                       remat_override=None,
                       master_override: str | None = None) -> MemoryPlan:
    """Pick (master/accum/moment dtypes, fused-GA, attn, remat) for SDXL.

    ``remat_override``/``master_override`` pin those axes when the user set
    the AOZORA_SDXL_REMAT env var or the MASTER_DTYPE config key.
    """
    trace: list[str] = []
    state_candidates = _state_candidates(ga_steps, master_override,
                                         requested_moment_dtype,
                                         allow_moments_host=(dp_shard == 1))
    ladder = _ladder_for(attn_pref)
    # The "fulltop" tier exists for buckets beyond 1024px; at <=1024px the
    # ladder is kept as it is.
    if max_latent_pixels <= 128 * 128:
        ladder = [e for e in ladder if e[2] != "fulltop"]
    if remat_override is not None:
        ladder = [(attn_pref, remat_override, None)]

    best_fallback = None  # smallest-estimate candidate, if nothing fits
    gather_modes = [True, False] if dp_shard > 1 else [True]
    for master, accum_dtype, fused, moment, host, two_pass in state_candidates:
        frozen_dtype = torch.bfloat16 if master == torch.bfloat16 else torch.float32
        st_by_mode = {
            g: state_bytes(trainable_elems, frozen_elems,
                           master_dtype=master, frozen_dtype=frozen_dtype,
                           accum_dtype=accum_dtype, moment_dtype=moment,
                           dp_shard=dp_shard, moments_host=host, fused=fused,
                           two_pass=two_pass, gather_once=g)
            for g in gather_modes}
        # first-fitting ladder rung per gather mode: gather-once (the bf16
        # weight tree resident) wins unless dropping it enables a rung at
        # least 2 positions faster
        fit_by_mode: dict[bool, tuple] = {}
        for g in gather_modes:
            st = st_by_mode[g]
            for idx, (attn_impl, remat, tier) in enumerate(ladder):
                act = activation_bytes(attn_impl, remat, batch_per_device,
                                       max_latent_pixels, tier)
                est = st["peak_state"] + act + _RESERVE_BYTES
                fits = budget_bytes is None or est <= budget_bytes
                trace.append(
                    f"{dtype_name(master)}-master/"
                    f"{'fused' if fused else dtype_name(accum_dtype) + '-accum'}/"
                    f"{moment if isinstance(moment, str) else dtype_name(moment)}-moments"
                    f"{'@host' if host else ''}"
                    f"{'/two-pass' if two_pass else ''}"
                    f"{'/gather-once' if g and dp_shard > 1 else ''}"
                    f" + {attn_impl}/remat={remat}{f'[{tier}]' if tier else ''}: "
                    f"state {st['peak_state'] / GB:.2f} + act {act / GB:.2f} "
                    f"+ reserve {_RESERVE_BYTES / GB:.2f} = {est / GB:.2f} GB "
                    f"{'<= ' if fits else '> '}"
                    f"{(budget_bytes or 0) / GB:.2f} -> "
                    f"{'fits' if fits else 'skip'}")
                if fits:
                    fit_by_mode[g] = (idx, attn_impl, remat, tier, int(est))
                    break
                plan = MemoryPlan(
                    master_dtype=master, frozen_dtype=frozen_dtype,
                    accum_dtype=accum_dtype, fused_apply=fused,
                    moment_dtype=moment, attn_impl=attn_impl, remat=remat,
                    est_bytes=int(est), budget_bytes=int(budget_bytes or 0),
                    reason="\n".join(trace), moments_host=host,
                    two_pass=two_pass,
                    remat_thresholds=((4160, int(max_latent_pixels) // 4)
                                      if tier == "fulltop" else None),
                    gather_once=g)
                if best_fallback is None or est < best_fallback.est_bytes:
                    best_fallback = plan
        if fit_by_mode:
            g = (True in fit_by_mode
                 and (False not in fit_by_mode
                      or fit_by_mode[True][0] <= fit_by_mode[False][0] + 1))
            idx, attn_impl, remat, tier, est = fit_by_mode[g]
            # "fulltop": full remat at and above a quarter of the bucket's
            # latent pixels
            thresholds = ((4160, int(max_latent_pixels) // 4)
                          if tier == "fulltop" else None)
            trace.append(
                f"-> SELECTED {attn_impl}/remat={remat}"
                f"{f'[{tier}]' if tier else ''} with "
                f"{'gather-once' if g else 'dp-sharded'} compute weights"
                if dp_shard > 1 else
                f"-> SELECTED {attn_impl}/remat={remat}"
                f"{f'[{tier}]' if tier else ''}")
            plan = MemoryPlan(
                master_dtype=master, frozen_dtype=frozen_dtype,
                accum_dtype=accum_dtype, fused_apply=fused,
                moment_dtype=moment, attn_impl=attn_impl, remat=remat,
                est_bytes=int(est), budget_bytes=int(budget_bytes or 0),
                reason="\n".join(trace), moments_host=host,
                two_pass=two_pass, remat_thresholds=thresholds,
                gather_once=g)
            return _gate_fast_backward(plan, batch_per_device,
                                       max_latent_pixels)

    # Nothing fits the estimate. The estimator is conservative, so run the
    # smallest-footprint configuration with a loud warning instead of
    # refusing; a real overflow then fails with this trace above it.
    print("WARNING: no training configuration fits the estimated per-device "
          f"HBM budget of {(budget_bytes or 0) / GB:.2f} GB; proceeding "
          "with the smallest-footprint candidate "
          f"({best_fallback.est_bytes / GB:.2f} GB estimated). If this "
          "OOMs: reduce BATCH_SIZE / bucket resolution, freeze more of "
          "the model (UNET_EXCLUDE_TARGETS), or run on more chips (FSDP "
          "shards master weights and moments across the dp axis).\n"
          + "\n".join(trace))
    return _gate_fast_backward(best_fallback, batch_per_device,
                               max_latent_pixels)


def describe_plan(plan: MemoryPlan, *, verbose: bool = False) -> str:
    budget = (f"{plan.budget_bytes / GB:.2f} GB" if plan.budget_bytes
              else "unbounded")
    lines = [
        "INFO: Memory plan "
        f"(budget {budget}, "
        f"est peak {plan.est_bytes / GB:.2f} GB):",
        f"INFO:   master weights: {dtype_name(plan.master_dtype)}"
        + ("  [LOW-MEMORY MODE: bf16 master via fp32 update scratch — "
           "the reference's own training precision]" if plan.low_memory
           else ""),
        f"INFO:   grad accumulation: "
        + ("two-pass step (GA=1: norm pass + recompute-update pass — "
           "the gradient tree never materializes)" if plan.two_pass
           else "fused into the train step (GA=1, no accum tree)"
           if plan.fused_apply
           else f"{dtype_name(plan.accum_dtype)} accum tree"),
        f"INFO:   moments: "
        + (plan.moment_dtype if isinstance(plan.moment_dtype, str)
           else dtype_name(plan.moment_dtype))
        + ("  [OFFLOADED to pinned host memory — streamed through the "
           "update like the reference's Raven/Titan CPU offload, but the "
           "math stays a fused on-device XLA kernel]"
           if plan.moments_host else ""),
        f"INFO:   attention: {plan.attn_impl}, remat: {plan.remat}"
        + (f" (resident < {plan.remat_thresholds[0]} tokens, FULL remat >= "
           f"{plan.remat_thresholds[1]} tokens)"
           if plan.remat_thresholds else ""),
    ]
    if not plan.gather_once:
        lines.append(
            "INFO:   multi-chip weights: dp-sharded compute (per-consumer "
            "gathers — HBM freed for a faster remat rung; gather-once "
            "replicas did not fit)")
    if not plan.fast_backward:
        lines.append(
            "INFO:   backward: legacy (GEMM conv backward + fused QKV "
            "gated — their ~0.30 MB/latent-pixel workspace does not fit "
            "next to this low-memory state rung)")
    if verbose:
        lines.append(plan.reason)
    return "\n".join(lines)
