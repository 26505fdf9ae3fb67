"""Raven-semantics AdamW (the reference's "Raven/Titan" math) in PyTorch.

Counterpart of ``aozora_sdxl_training_tpu/opt/adamw.py``, keeping the math
that shapes training curves:

* partial bias correction: ``bc = 1 - (1 - bc) * debias_strength``;
* decoupled weight decay applied as ``p *= 1 - lr * wd`` *before* the Adam
  update;
* moments stored in a configurable dtype (bf16 default) while the update
  itself is fp32, for any parameter storage dtype;
* ``int8_blockwise`` moments (``paged_adamw_8bit``): int8 codes with one
  fp32 absmax scale per 256 elements, the second moment in the sqrt
  domain, and fp32 moments for tensors under ``min_8bit_size``.

Unlike the JAX version, parameters and moments are updated in place (one
tensor's fp32 scratch alive at a time), which keeps the port's memory at
parameters + moments. ``update_tensor`` is one tensor's update: the apply
step's loop (``apply_updates``) and the two-pass step's gradient hooks
(``train/train_step.py``) both run it.

The JAX package lays a conv out HWIO and a linear (in, out), the port OIHW
and (out, in). An int8 moment's blocks run over the tensor's flat order, so
its codes are kept in the JAX package's layout (``Layout``: the model's
``to_jax_layout`` and ``from_jax_layout``) and come out code for code as
the JAX package's; the fp32 moment is viewed in that layout to be
quantized and back after it is dequantized.

Host moments (the memory plan's ``moments_host`` rung, the reference's
Raven/Titan CPU offload): the moments live in one pinned host buffer, and
``apply_updates`` streams them through a bounded staging window on the
card (``HostMoments``) in chunks of consecutive tensors: for each chunk one
H2D copy on a copy stream, the updates of its tensors on the compute
stream after it, and one D2H copy of the new moments back into the same
pinned bytes on a second copy stream; the next chunks' H2D copies run
ahead while the window has room, and events keep a window slot from being
refilled before its D2H copy is done. On the CPU (tests) the host is the
device and the same windowed code runs without streams.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


INT8_BLOCK = 256  # elements per quantization block for int8 moment storage


class Layout(NamedTuple):
    """How the JAX package lays out each parameter: ``to_jax(name, t)``
    views a tensor of the port's layout in the JAX package's, ``from_jax``
    is its inverse. ``numel(name, t)`` is the element count of the whole
    parameter that ``t`` holds (under FSDP a shard holds part of one:
    ``parallel/sharding.FSDP.opt_layout``); None: ``t``'s own.
    ``part(name)`` -> (lead, merge) where ``t`` is a part of its parameter
    that may start inside an int8 block (a pipeline stage's slice of a
    stacked leaf): ``lead`` elements of its first block lie before it, and
    ``merge`` takes the part's block maxima to the whole blocks' (a
    collective; None where every part starts on a block); None: (0, None).
    ``spread(name)`` -> a ``Spread`` where ``t`` is a part whose elements
    lie scattered over its parameter's blocks (a tensor-parallel column
    slice), else None."""
    to_jax: Callable[[str, torch.Tensor], torch.Tensor]
    from_jax: Callable[[str, torch.Tensor], torch.Tensor]
    numel: Callable[[str, torch.Tensor], int] | None = None
    part: Callable[[str], tuple] | None = None
    spread: Callable[[str], Any] | None = None

    def elements(self, name: str, t: torch.Tensor) -> int:
        return t.numel() if self.numel is None else self.numel(name, t)

    def int8_part(self, name: str) -> tuple:
        return (0, None) if self.part is None else self.part(name)

    def int8_spread(self, name: str):
        return None if self.spread is None else self.spread(name)

    def scale_blocks(self, name: str, t: torch.Tensor) -> int:
        """The int8 scales that ``t``'s codes take."""
        spread = self.int8_spread(name)
        if spread is not None:
            return spread.blocks
        return _int8_blocks(self.int8_part(name)[0] + t.numel())


class Spread(NamedTuple):
    """A part of a parameter whose elements lie scattered over the whole
    parameter's int8 blocks: it holds the whole parameter's ``blocks``
    scales; ``ids(device)`` is the block of each of its elements in its own
    flat (JAX layout) order, and ``merge`` takes the part's block maxima to
    the whole blocks' (a collective over the parts' ranks)."""
    blocks: int
    ids: Callable[[Any], torch.Tensor]
    merge: Callable[[torch.Tensor], torch.Tensor]


def _same(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


SAME_LAYOUT = Layout(_same, _same)


@dataclass(frozen=True)
class AdamWConfig:
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    debias_strength: float = 0.3
    # a torch dtype, or the string "int8_blockwise" for 8-bit moments with
    # per-256-element fp32 absmax scales
    momentum_dtype: Any = torch.bfloat16
    # tensors smaller than this keep fp32 moments under int8_blockwise
    min_8bit_size: int = 4096

    @property
    def int8_state(self) -> bool:
        return self.momentum_dtype == "int8_blockwise"

    def int8_for(self, n_elements: int) -> bool:
        """Whether a tensor of ``n_elements`` gets int8-quantized moments."""
        return self.int8_state and int(n_elements) >= int(self.min_8bit_size)

    @classmethod
    def from_params_dict(cls, raw: dict) -> "AdamWConfig":
        name = str(raw.get("momentum_dtype", "bfloat16"))
        dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32,
                 "int8": "int8_blockwise",
                 "int8_blockwise": "int8_blockwise"}.get(name, torch.bfloat16)
        return cls(
            betas=tuple(raw.get("betas", (0.9, 0.999))),
            eps=float(raw.get("eps", 1e-8)),
            weight_decay=float(raw.get("weight_decay", 0.01)),
            debias_strength=float(raw.get("debias_strength", 1.0)),
            momentum_dtype=dtype,
            min_8bit_size=int(raw.get("min_8bit_size", 4096)),
        )


def _int8_blocks(n: int) -> int:
    return -(-n // INT8_BLOCK)


def quantize_moment_int8(m32: torch.Tensor, lead: int = 0, merge=None, spread=None):
    """fp32 tensor -> (int8 codes [same shape], fp32 scales [n_blocks]):
    256-element blocks over the flat order, each block's absmax (over its
    zero padding too) / 127 as its scale, codes rounded half to even.
    ``lead``/``merge``: ``m32`` is a part of a tensor that starts ``lead``
    elements into its first block, and ``merge`` gives the whole blocks'
    absmax from the part's (``Layout.part``). ``spread``: (block ids, block
    count, merge) of a part scattered over the blocks (``Spread``); the
    codes and the whole blocks' scales are then the whole tensor's."""
    if spread is not None:
        ids, nb, merge = spread
        flat = m32.reshape(-1)
        amax = torch.zeros(nb, dtype=flat.dtype, device=flat.device).scatter_reduce_(
            0, ids, flat.abs(), "amax")
        scales = torch.clamp(merge(amax), min=1e-30) / 127.0
        codes = torch.clamp(torch.round(flat / scales[ids]), -127, 127)
        return codes.reshape(m32.shape).to(torch.int8), scales.float()
    flat = m32.reshape(-1)
    n = flat.numel()
    nb = _int8_blocks(lead + n)
    blocks = F.pad(flat, (lead, nb * INT8_BLOCK - n - lead)).view(nb, INT8_BLOCK)
    amax = blocks.abs().amax(dim=1)
    if merge is not None:
        amax = merge(amax)
    scales = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return (codes.view(-1)[lead:lead + n].reshape(m32.shape).to(torch.int8),
            scales.float())


def dequantize_moment_int8(codes: torch.Tensor, scales: torch.Tensor,
                           lead: int = 0, spread=None) -> torch.Tensor:
    if spread is not None:
        return (codes.reshape(-1).float() * scales[spread[0]]).reshape(codes.shape)
    flat = codes.reshape(-1).float()
    n, nb = flat.numel(), scales.shape[0]
    out = F.pad(flat, (lead, nb * INT8_BLOCK - n - lead)).view(nb, INT8_BLOCK)
    out = out * scales[:, None]
    return out.view(-1)[lead:lead + n].reshape(codes.shape)


def quantize_second_moment_int8(v32: torch.Tensor, lead: int = 0, merge=None,
                                spread=None):
    """Second moments quantize in the sqrt domain: v spans ~6 orders of
    magnitude within a block, sqrt(v) only ~3. The root is taken in float64
    and rounded once to fp32, the correctly rounded root that XLA gives:
    torch's vectorized CPU sqrt (0.5001 ulp) misses it now and then, which
    moves a block's scale by an ulp."""
    root = torch.sqrt(torch.clamp(v32, min=0.0).double()).float()
    return quantize_moment_int8(root, lead, merge, spread)


def dequantize_second_moment_int8(codes: torch.Tensor, scales: torch.Tensor,
                                  lead: int = 0, spread=None):
    root = dequantize_moment_int8(codes, scales, lead, spread)
    return root * root


class HostMoments:
    """Moments in one pinned host buffer, and the staging window through
    which ``apply_updates`` streams them.

    ``pieces`` lists each tensor's moment pieces, (shape, dtype) in update
    order: the first moment's (the int8 codes and scales, or one float
    tensor), then the second's. They are laid out one after another in
    the host buffer (``moments`` holds each tensor's (first, second)
    moment as views of it, pinned when ``device`` is a CUDA device; each
    chunk's ``moments`` the same in its window slot) and cut into chunks of
    consecutive tensors of at most a quarter of the window each (a larger
    tensor is a chunk of its own). The chunks' places in the
    ``window_bytes`` of device memory (the memory plan counts 0.5 GB for
    it) are fixed once, in ring order; a chunk larger than the window goes
    to a spill buffer of its own, grown to the largest such chunk. A
    chunk's slot is refilled only after the D2H copy of every chunk it
    overlaps. On a CUDA device the copies run on two copy streams; on the
    CPU there are no streams and every copy is done when it returns."""

    ALIGN = 16

    def __init__(self, device, window_bytes: int, pieces: dict):
        self.device = torch.device(device)
        self.window = int(window_bytes)
        cuda = self.device.type == "cuda"
        offsets, total = {}, 0
        for name, specs in pieces.items():
            offsets[name] = []
            for shape, dtype in specs:
                nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
                offsets[name].append((total, nbytes, tuple(shape), dtype))
                total += -(-nbytes // self.ALIGN) * self.ALIGN
        self.buffer = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
        if cuda and not self.buffer.is_pinned():
            raise RuntimeError("host moments: the host buffer could not be pinned")
        self.moments = {name: _pair([self.buffer[o:o + n].view(dtype).view(shape)
                                     for o, n, shape, dtype in offs])
                        for name, offs in offsets.items()}
        self.chunks = self._plan(offsets)
        spill = max((c["size"] for c in self.chunks if c["spill"]), default=0)
        self.arena = torch.empty(self.window, dtype=torch.uint8, device=self.device)
        self.spill = torch.empty(spill, dtype=torch.uint8, device=self.device)
        for c in self.chunks:
            dev = (self.spill if c["spill"] else self.arena)[c["slot"]:c["slot"] + c["size"]]
            c["host"] = self.buffer[c["start"]:c["start"] + c["size"]]
            c["dev"] = dev
            c["moments"] = {name: _pair([dev[o - c["start"]:o - c["start"] + n]
                                         .view(dtype).view(shape)
                                         for o, n, shape, dtype in offsets[name]])
                            for name in c["names"]}
        self.h2d = torch.cuda.Stream(self.device) if cuda else None
        self.d2h = torch.cuda.Stream(self.device) if cuda else None
        self.last = None                # the last D2H copy's event
        self.bytes_h2d = self.bytes_d2h = 0

    def _plan(self, offsets: dict) -> list:
        """Chunks of consecutive tensors: {names, start, size (host bytes),
        spill, slot (device offset), after (the last earlier chunk whose
        slot this one overlaps, or -1)}."""
        cap = max(self.window // 4, 1)
        chunks, cur = [], None
        for name, offs in offsets.items():
            start = offs[0][0]
            end = offs[-1][0] + offs[-1][1]
            if cur is not None and end - cur["start"] <= cap:
                cur["names"].append(name)
                cur["size"] = end - cur["start"]
                continue
            cur = {"names": [name], "start": start, "size": end - start}
            chunks.append(cur)
        head, placed = 0, []
        for i, c in enumerate(chunks):
            c["spill"] = c["size"] > self.window
            if c["spill"]:
                c["slot"] = 0
                c["after"] = max((j for j in range(i) if chunks[j]["spill"]), default=-1)
                continue
            if head + c["size"] > self.window:
                head = 0
            c["slot"], head = head, head + c["size"]
            c["after"] = max((j for j in placed
                              if chunks[j]["slot"] < c["slot"] + c["size"]
                              and c["slot"] < chunks[j]["slot"] + chunks[j]["size"]),
                             default=-1)
            placed.append(i)
        return chunks

    def _record(self, stream):
        if stream is None:
            return True
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def stage(self, i: int, events: list) -> None:
        """Issues chunk ``i``'s H2D copy on the H2D stream, after the D2H
        copy of the chunk whose slot it refills (``events``: the D2H event
        of each chunk issued this step); ``events`` gets its H2D event."""
        c = self.chunks[i]
        with _on(self.h2d):
            if self.h2d is not None and c["after"] >= 0:
                self.h2d.wait_event(events[c["after"]][1])
            c["dev"].copy_(c["host"], non_blocking=True)
            events.append([self._record(self.h2d), None])
        self.bytes_h2d += c["size"]

    def unstage(self, i: int, events: list) -> None:
        """Issues chunk ``i``'s D2H copy on the D2H stream, after the
        compute stream's work so far (its tensors' updates)."""
        c = self.chunks[i]
        if self.d2h is not None:
            self.d2h.wait_stream(torch.cuda.current_stream(self.device))
        with _on(self.d2h):
            c["host"].copy_(c["dev"], non_blocking=True)
            self.last = events[i][1] = self._record(self.d2h)
        self.bytes_d2h += c["size"]

    def synchronize(self) -> None:
        """Waits until the host moments hold the last step's values."""
        if self.last is not None and self.last is not True:
            self.last.synchronize()


def _pair(views: list):
    """(first moment, second moment) from a tensor's moment pieces: an int8
    moment as (codes, scales), a float one as its tensor."""
    half = len(views) // 2
    pack = tuple if half == 2 else (lambda ts: ts[0])
    return pack(views[:half]), pack(views[half:])


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


@dataclass
class AdamWState:
    step: int                       # shared across params
    exp_avg: dict                   # {name: tensor} in momentum_dtype, or
    exp_avg_sq: dict                # {name: (int8 codes, fp32 scales)}
    # the layout of the int8 codes (the JAX package's); float moments are
    # in the port's layout
    layout: Layout = SAME_LAYOUT
    # set when the moments live in host memory (the moments_host rung)
    host: HostMoments | None = None


def _moment_storage(name: str, p: torch.Tensor, cfg: AdamWConfig,
                    layout: Layout):
    """(shape, dtype) of one moment of ``p``: int8 codes in the JAX
    layout's shape, or the parameter's shape in the moment dtype."""
    if cfg.int8_for(layout.elements(name, p)):
        return tuple(layout.to_jax(name, p).shape), torch.int8
    return tuple(p.shape), (torch.float32 if cfg.int8_state else cfg.momentum_dtype)


def _host_state(params: dict, cfg: AdamWConfig, layout: Layout, host_window: int):
    """A ``HostMoments`` for ``params``' moments, and its (exp_avg,
    exp_avg_sq) dicts of host views (an int8 moment as (codes, scales))."""
    def specs(name, p):
        shape, dtype = _moment_storage(name, p, cfg, layout)
        if dtype == torch.int8:
            return [(shape, dtype), ((layout.scale_blocks(name, p),), torch.float32)]
        return [(shape, dtype)]

    device = next(iter(params.values())).device if params else torch.device("cpu")
    pieces = {name: specs(name, p) * 2 for name, p in params.items()}
    host = HostMoments(device, host_window, pieces)
    return (host, {n: m for n, (m, _) in host.moments.items()},
            {n: v for n, (_, v) in host.moments.items()})


def init_state(params: dict, cfg: AdamWConfig, layout: Layout = SAME_LAYOUT, *,
               host_window: int | None = None) -> AdamWState:
    """Zero moments; an int8 moment is (zero codes, scales of 1e-30). With
    ``host_window`` (bytes), the moments are made in host memory (pinned
    for a CUDA device) and stream through a window of that size."""
    if host_window is not None:
        host, m, v = _host_state(params, cfg, layout, host_window)
        for moment in (m, v):
            for value in moment.values():
                if isinstance(value, tuple):
                    value[0].zero_()
                    value[1].fill_(1e-30)
                else:
                    value.zero_()
        return AdamWState(step=0, exp_avg=m, exp_avg_sq=v, layout=layout, host=host)

    def zeros():
        out = {}
        for name, p in params.items():
            shape, dtype = _moment_storage(name, p, cfg, layout)
            out[name] = torch.zeros(shape, dtype=dtype, device=p.device)
            if dtype == torch.int8:
                out[name] = (out[name], torch.full(
                    (layout.scale_blocks(name, p),), 1e-30, dtype=torch.float32,
                    device=p.device))
        return out
    return AdamWState(step=0, exp_avg=zeros(), exp_avg_sq=zeros(), layout=layout)


def restored_state(host: AdamWState, params: dict, cfg: AdamWConfig, *,
                   host_window: int | None = None) -> AdamWState:
    """A state read from a file (host tensors, keyed like ``params``) on
    the parameters' device, one moment at a time: float moments in the
    dtype ``init_state`` gives them, int8 codes and scales as they are.
    With ``host_window``, the moments go to pinned host memory instead (the
    ``moments_host`` rung), never through the card. Raises when a moment's
    storage (int8 or float, and its shape) is not what ``cfg`` asks for
    that parameter."""
    def checked(name, value, p):
        shape, dtype = _moment_storage(name, p, cfg, host.layout)
        int8 = dtype == torch.int8
        got = tuple((value[0] if isinstance(value, tuple) else value).shape)
        if isinstance(value, tuple) != int8 or got != shape:
            raise ValueError(
                f"resume state: the moment of {name} ({got}) does not fit the "
                f"optimizer ({'int8 codes' if int8 else dtype} of shape "
                f"{shape} for momentum dtype {cfg.momentum_dtype})")
        return value, dtype

    if host_window is not None:
        moments, m, v = _host_state(params, cfg, host.layout, host_window)
        for field, into in ((host.exp_avg, m), (host.exp_avg_sq, v)):
            for name, p in params.items():
                value, _ = checked(name, field[name], p)
                for dst, src in zip(*((t if isinstance(t, tuple) else (t,))
                                      for t in (into[name], value))):
                    dst.copy_(src)
        return AdamWState(step=int(host.step), layout=host.layout, host=moments,
                          exp_avg=m, exp_avg_sq=v)

    def move(name, value, p):
        value, dtype = checked(name, value, p)
        if isinstance(value, tuple):
            return tuple(t.to(p.device) for t in value)
        return value.to(device=p.device, dtype=dtype).contiguous()

    return AdamWState(
        step=int(host.step), layout=host.layout,
        exp_avg={n: move(n, host.exp_avg[n], p) for n, p in params.items()},
        exp_avg_sq={n: move(n, host.exp_avg_sq[n], p) for n, p in params.items()})


def step_scalars(cfg: AdamWConfig, step: int, lr: float):
    """fp32 scalars as the JAX update computes them: (step size, sqrt of the
    second bias correction, weight-decay factor)."""
    f32 = np.float32
    beta1, beta2 = cfg.betas
    bc1 = f32(1.0) - f32(np.power(np.float64(f32(beta1)), step))
    bc2 = f32(1.0) - f32(np.power(np.float64(f32(beta2)), step))
    if cfg.debias_strength < 1.0:
        bc1 = f32(1.0) - (f32(1.0) - bc1) * f32(cfg.debias_strength)
        bc2 = f32(1.0) - (f32(1.0) - bc2) * f32(cfg.debias_strength)
    step_size = f32(lr) / bc1
    wd_factor = f32(1.0) - f32(lr) * f32(cfg.weight_decay)
    return float(step_size), float(np.sqrt(bc2)), float(wd_factor)


@torch.no_grad()
def update_tensor(name: str, p: torch.Tensor, grad: torch.Tensor, m, v,
                  cfg: AdamWConfig, scalars: tuple, layout: Layout = SAME_LAYOUT):
    """One tensor's AdamW update, in place: the parameter ``p`` and its
    moments ``m``, ``v`` (tensors, or int8 (codes, scales) in the JAX
    layout), from ``grad`` and ``step_scalars``. Returns the squared L2
    norm of the fp32 parameter delta (0-d fp32)."""
    beta1, beta2 = cfg.betas
    step_size, sqrt_bc2, wd_factor = scalars
    g32 = grad.float()
    del grad
    int8_here = isinstance(m, tuple)
    if int8_here:
        lead, merge = layout.int8_part(name)
        spread = layout.int8_spread(name)
        if spread is not None:
            spread = (spread.ids(m[0].device), spread.blocks, spread.merge)
        m32 = layout.from_jax(name, dequantize_moment_int8(*m, lead, spread))
        v32 = layout.from_jax(name, dequantize_second_moment_int8(*v, lead, spread))
    else:
        m32, v32 = m.float(), v.float()
    m32 = m32 * beta1 + g32 * (1.0 - beta1)
    v32 = v32 * beta2 + g32 * g32 * (1.0 - beta2)
    p32_orig = p.float()
    p32 = p32_orig * wd_factor if cfg.weight_decay != 0.0 else p32_orig
    p32 = p32 - step_size * m32 / (torch.sqrt(v32) / sqrt_bc2 + cfg.eps)
    usq = ((p32 - p32_orig) ** 2).sum()
    p.copy_(p32)
    if int8_here:
        for held, new in zip((*m, *v), (
                *quantize_moment_int8(layout.to_jax(name, m32), lead, merge, spread),
                *quantize_second_moment_int8(layout.to_jax(name, v32), lead, merge,
                                             spread))):
            held.copy_(new)
    else:
        m.copy_(m32)
        v.copy_(v32)
    return usq


def _streamed_updates(params: dict, grads: dict, state: AdamWState,
                      cfg: AdamWConfig, scalars: tuple, release: bool):
    """``apply_updates`` over host moments: chunk by chunk, staged in the
    window, its tensors updated there, and copied back; the next chunks'
    H2D copies issued ahead while their slots are free."""
    host = state.host
    chunks = host.chunks
    # the host moments hold the last step's values once its D2H copies end
    if host.h2d is not None and host.last is not None:
        host.h2d.wait_event(host.last)
    events: list = []               # [H2D event, D2H event] of each chunk issued
    update_sq = None

    def fill(done: int) -> None:
        # a chunk is staged once the chunk whose slot it refills is copied out
        while len(events) < len(chunks) and chunks[len(events)]["after"] <= done:
            host.stage(len(events), events)

    fill(-1)
    for i, c in enumerate(chunks):
        if host.h2d is not None:
            torch.cuda.current_stream(host.device).wait_event(events[i][0])
        for name in c["names"]:
            usq = update_tensor(name, params[name], grads.pop(name) if release else grads[name],
                                *c["moments"][name], cfg, scalars, state.layout)
            update_sq = usq if update_sq is None else update_sq + usq
        host.unstage(i, events)
        fill(i)
    return update_sq


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: AdamWState,
                  cfg: AdamWConfig, *, lr: float, release: bool = False):
    """One in-place AdamW step with Raven debias semantics. With
    ``release``, each gradient leaves ``grads`` once its tensor is updated
    (it is freed there when ``grads`` held its last reference). Host
    moments (``state.host``) stream through their window.

    Returns (params, state, update_sq): ``update_sq`` is the squared global
    L2 norm of the fp32 parameter delta, as a 0-d fp32 tensor."""
    state.step += 1
    scalars = step_scalars(cfg, state.step, lr)
    update_sq = None
    if state.host is not None:
        update_sq = _streamed_updates(params, grads, state, cfg, scalars, release)
    else:
        for name, p in params.items():
            usq = update_tensor(name, p, grads.pop(name) if release else grads[name],
                                state.exp_avg[name], state.exp_avg_sq[name], cfg,
                                scalars, state.layout)
            update_sq = usq if update_sq is None else update_sq + usq
    if update_sq is None:
        update_sq = torch.zeros((), dtype=torch.float32)
    return params, state, update_sq


def global_grad_norm(grads: dict) -> torch.Tensor:
    sq = None
    for g in grads.values():
        s = (g.float() ** 2).sum()
        sq = s if sq is None else sq + s
    return torch.sqrt(sq) if sq is not None else torch.zeros(())


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that clips gradients of global norm ``norm`` to
    ``max_norm`` (0-d; at most 1)."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


@torch.no_grad()
def clip_tensor_(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g`` scaled in place by ``scale``, in fp32, stored in its dtype."""
    return g.copy_(g.float() * scale)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, norm: torch.Tensor | None = None):
    """Scales ``grads`` in place; returns (grads, raw_norm as a 0-d tensor).
    max_norm <= 0 disables clipping. ``norm``: the global norm where
    ``grads`` hold part of it (under FSDP, ``FSDP.grad_norm``); by
    default theirs."""
    norm = global_grad_norm(grads) if norm is None else norm
    if max_norm is None or max_norm <= 0:
        return grads, norm
    scale = clip_scale(norm, max_norm)
    for g in grads.values():
        clip_tensor_(g, scale)
    return grads, norm
