"""PyTorch port: the memory plan's two low-memory rungs at GA 1.

* The two-pass step (``train_step.make_two_pass_step``) against the fused
  step (a micro step, then the apply step) from the same bf16 masters,
  int8 moments and batch, under every remat mode the plan can give at GA 1
  (SDXL, a two-level cut of TINY: off, full, the ``dots*`` policies and
  the ``_hires`` tiers, full remat at 64 tokens and the policy at 16; the
  TINY Anima DiT: Off, Full, Conservative), with a clip that binds: the same
  loss; the raw gradient norm within rtol 1e-6 (pass 1 sums the tensors'
  squares in the backward's order, the fused step in the parameters');
  parameters within one bf16 step and int8 codes within one code (a clip
  factor one fp32 ulp apart can move a clipped bf16 gradient by one bf16
  step; Adam's first update hardly depends on a gradient's size, so in
  practice both come out equal).
* The step's passes: two forwards with the clip on, one with it off (and
  then the fused step's result); at each tensor's hook that tensor's
  gradient is the only one alive, and no ``.grad`` or hook is left after
  the step.
* Host moments (``opt/adamw.HostMoments``) on the CPU, where the host is
  the device: the windowed apply equals the in-memory apply bit for bit,
  with a window smaller than the largest tensor's moments and one larger,
  for int8 and bf16 moments; each step moves every chunk of moments once
  each way.
"""

import weakref
from dataclasses import replace

import numpy as np
import pytest
import torch

from aozora_sdxl_training_tpu.models.sdxl.arch import TINY
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import params_from_jax
from aozora_sdxl_training_tpu_torch.opt import adamw
from aozora_sdxl_training_tpu_torch.train import anima_trainer as port_anima
from aozora_sdxl_training_tpu_torch.train import train_step as ts

from tests.test_torch_port_anima_dit import numpy_params as dit_numpy_params
from tests.test_torch_port_anima_trainer import CFG as DIT_CFG
from tests.test_torch_port_anima_trainer import LAT as DIT_LAT
from tests.test_torch_port_trainer import one_thread
from tests.test_torch_port_unet import numpy_params as unet_numpy_params

OPT = adamw.AdamWConfig(debias_strength=0.3, momentum_dtype="int8_blockwise",
                        min_8bit_size=256)
CLIP = 0.05          # below the TINY models' gradient norms: the clip binds
LR = 1e-3
# TINY cut to two levels (attention at the second), so that the remat
# matrix stays cheap; at 8 x 8 latents the levels hold 64 and 16 tokens
SMALL = replace(TINY, block_out_channels=(16, 32), transformer_layers=(0, 1),
                num_heads=(2, 2), mid_transformer_layers=1, norm_num_groups=4)


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    with one_thread():
        yield


def _sdxl(remat, clip=CLIP):
    rng = np.random.default_rng(8)
    params = params_from_jax(unet_numpy_params(SMALL, rng))
    cfg = ts.TrainStepConfig(unet=SMALL, grad_accum_steps=1, clip_grad_norm=clip,
                             compute_dtype=torch.bfloat16, remat=remat,
                             remat_thresholds=(16, 64) if str(remat).endswith("_hires") else None)
    batch = (torch.from_numpy(rng.normal(size=(1, 8, 8, 4)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(1, 10, SMALL.cross_attention_dim))
                              .astype(np.float32)),
             torch.from_numpy(rng.normal(size=(1, SMALL.pooled_projection_dim))
                              .astype(np.float32)),
             torch.from_numpy(rng.normal(size=(1, 6)).astype(np.float32)),
             torch.tensor([417]), torch.ones(1), torch.ones(1000), 7, 1)
    return params, cfg, ts.make_loss_fn(cfg), ts.make_micro_step(cfg), batch


def _anima(remat, clip=CLIP):
    rng = np.random.default_rng(8)
    params = port_dit.params_from_jax(dit_numpy_params(DIT_CFG, rng))
    cfg = port_anima.AnimaStepConfig(dit=DIT_CFG, grad_accum_steps=1, clip_grad_norm=clip,
                                     remat=remat)
    batch = (torch.from_numpy(rng.normal(size=(1, DIT_LAT, DIT_LAT, DIT_CFG.in_channels))
                              .astype(np.float32)),
             torch.from_numpy(rng.normal(size=(1, 12, DIT_CFG.adapter_source_dim))
                              .astype(np.float32)),
             torch.from_numpy(rng.integers(1, DIT_CFG.adapter_vocab, (1, 12))),
             torch.tensor([613]), torch.ones(1), torch.ones(1000), 7, 1)
    return (params, cfg, port_anima.make_anima_loss_fn(cfg),
            port_anima.make_anima_micro_step(cfg), batch)


def _fresh(params):
    trainable = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in params.items()}
    return trainable, adamw.init_state(trainable, OPT)


def _fused(params, cfg, micro, batch):
    trainable, state = _fresh(params)
    loss, _ = micro(trainable, {}, *batch, 0.0)
    raw, _ = ts.make_apply_step(cfg, OPT)(trainable, state, LR)
    return trainable, state, float(loss), float(raw)


def _within_one_step(two, fused, two_state, fused_state):
    for name, p in fused.items():
        a, b = two[name].detach().float(), p.detach().float()
        ulp = torch.finfo(torch.bfloat16).eps * b.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
        assert bool(((a - b).abs() <= ulp).all()), name
        for got, want in ((two_state.exp_avg[name], fused_state.exp_avg[name]),
                          (two_state.exp_avg_sq[name], fused_state.exp_avg_sq[name])):
            if isinstance(want, tuple):
                assert int((got[0].int() - want[0].int()).abs().max()) <= 1, name
                torch.testing.assert_close(got[1], want[1], rtol=2.0 ** -7, atol=0)
            else:
                torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-30)


@pytest.mark.parametrize("model,remat", [
    ("sdxl", False), ("sdxl", True), ("sdxl", "dots"), ("sdxl", "dots_no_batch"),
    ("sdxl", "dots_no_logits"), ("sdxl", "dots_no_logits_hires"), ("sdxl", "full_hires"),
    ("anima", False), ("anima", True), ("anima", "conservative")])
def test_two_pass_step_matches_the_fused_step(model, remat):
    params, cfg, loss_fn, micro, batch = (_sdxl if model == "sdxl" else _anima)(remat)
    fused, fused_state, fused_loss, fused_raw = _fused(params, cfg, micro, batch)
    trainable, state = _fresh(params)
    loss, _, raw, update = ts.make_two_pass_step(loss_fn, OPT, CLIP)(
        trainable, {}, state, *batch, lr=LR)
    print(f"{model} remat {remat}: loss {float(loss)} / {fused_loss}, raw norm {float(raw)} / "
          f"{fused_raw}, weights differing "
          f"{sum(int((trainable[k] != p).sum()) for k, p in fused.items())}")
    assert float(loss) == fused_loss
    assert float(raw) == pytest.approx(fused_raw, rel=1e-6) and fused_raw > CLIP
    assert state.step == fused_state.step == 1 and float(update) > 0
    _within_one_step(trainable, fused, state, fused_state)
    assert all(p.grad is None for p in trainable.values())


@pytest.mark.parametrize("clip", [CLIP, 0.0], ids=["clip", "no_clip"])
def test_two_pass_step_runs_its_passes_and_frees_each_gradient(clip, monkeypatch):
    """Two forwards with the clip on, one with it off. At each update (a
    hook of pass 2, or of the one pass) no ``.grad`` is set and every
    gradient updated before is freed: the tensor's own gradient is the
    only one alive. No gradient or hook is left after the step; without
    the clip the step is the fused step's (the norm summed in another
    order apart)."""
    params, cfg, loss_fn, micro, batch = _sdxl(False, clip)
    forwards = []

    def counted(*args, **kw):
        forwards.append(1)
        return loss_fn(*args, **kw)

    trainable, state = _fresh(params)
    seen, alive = [], []
    real = adamw.update_tensor

    def probed(name, p, grad, *args, **kw):
        alive.append((sum(q.grad is not None for q in trainable.values()),
                      sum(r() is not None for r in seen)))
        seen.append(weakref.ref(grad))
        return real(name, p, grad, *args, **kw)

    monkeypatch.setattr(adamw, "update_tensor", probed)
    loss, _, raw, _ = ts.make_two_pass_step(counted, OPT, clip)(
        trainable, {}, state, *batch, lr=LR)
    assert len(forwards) == (2 if clip else 1)
    assert len(alive) == len(trainable) and set(alive) == {(0, 0)}
    assert all(p.grad is None and not p._post_accumulate_grad_hooks
               for p in trainable.values())
    monkeypatch.setattr(adamw, "update_tensor", real)
    fused, fused_state, fused_loss, fused_raw = _fused(params, cfg, micro, batch)
    assert float(loss) == fused_loss and float(raw) == pytest.approx(fused_raw, rel=1e-6)
    _within_one_step(trainable, fused, state, fused_state)


def test_two_pass_step_refuses_host_moments():
    params, cfg, loss_fn, _, batch = _sdxl(False)
    trainable = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in params.items()}
    state = adamw.init_state(trainable, OPT, host_window=1 << 20)
    with pytest.raises(ValueError, match="on the device"):
        ts.make_two_pass_step(loss_fn, OPT, CLIP)(trainable, {}, state, *batch, lr=LR)


@pytest.mark.parametrize("momentum", ["int8_blockwise", "bfloat16"])
@pytest.mark.parametrize("window", ["below_largest", "above_largest"])
def test_windowed_host_apply_matches_the_in_memory_apply(momentum, window):
    """Three apply steps over bf16 parameters of many shapes (one under
    ``min_8bit_size``, fp32 moments there): host moments streamed through
    the window give the in-memory apply's parameters and moments bit for
    bit, and every step moves each chunk of moments in and out once (the
    largest tensor's moments go to the spill buffer when the window is
    smaller than them)."""
    cfg = adamw.AdamWConfig.from_params_dict({"momentum_dtype": momentum,
                                              "min_8bit_size": 512})
    g = torch.Generator().manual_seed(5)
    shapes = {"conv": (32, 16, 3, 3), "proj": (96, 80), "big": (160, 128), "norm": (48,),
              "bias": (300,), "tail": (70, 33)}
    params = {n: torch.randn(s, generator=g).to(torch.bfloat16) for n, s in shapes.items()}
    grads = [{n: torch.randn(s, generator=g).to(torch.bfloat16) for n, s in shapes.items()}
             for _ in range(3)]
    probe = adamw.init_state(params, cfg)
    sizes = {n: sum(t.numel() * t.element_size() for m in (probe.exp_avg[n], probe.exp_avg_sq[n])
                    for t in (m if isinstance(m, tuple) else (m,)))
             for n in params}
    largest = max(sizes.values())
    window_bytes = largest // 3 if window == "below_largest" else 3 * largest
    runs = []
    for host_window in (None, window_bytes):
        trainable = {n: p.clone() for n, p in params.items()}
        state = adamw.init_state(trainable, cfg, host_window=host_window)
        norms = [adamw.apply_updates(trainable, dict(grad), state, cfg, lr=1e-3 * (i + 1),
                                     release=True)[2] for i, grad in enumerate(grads)]
        runs.append((trainable, state, norms))
    (p_mem, s_mem, n_mem), (p_host, s_host, n_host) = runs
    assert s_host.host is not None and s_host.host.window == window_bytes
    assert all(torch.equal(a, b) for a, b in zip(n_host, n_mem))
    for name in params:
        assert torch.equal(p_host[name], p_mem[name]), name
        for got, want in ((s_host.exp_avg[name], s_mem.exp_avg[name]),
                          (s_host.exp_avg_sq[name], s_mem.exp_avg_sq[name])):
            for a, b in zip(*((t if isinstance(t, tuple) else (t,)) for t in (got, want))):
                assert torch.equal(a, b), name
    # each step copies every chunk in and out once: the moments' bytes and
    # the padding that aligns each piece in the host buffer
    moved = 3 * sum(c["size"] for c in s_host.host.chunks)
    assert s_host.host.bytes_h2d == s_host.host.bytes_d2h == moved
    assert 3 * sum(sizes.values()) <= moved <= 3 * s_host.host.buffer.numel()
    assert any(c["spill"] for c in s_host.host.chunks) == (window == "below_largest")
