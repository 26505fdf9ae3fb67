"""Tensor parallelism: Megatron's column and row splits over the tp ranks.

The JAX package runs tensor parallelism by sharding: ``tp_param_spec``
(``parallel/sharding.py``) gives the attention and MLP weights a ``"tp"``
axis on a ``("dp", "tp")`` mesh and GSPMD inserts the collectives. The
port computes the same function by hand, Megatron-style:

* a column-parallel layer (q/k/v, the GEGLU and MLP up-projections) holds
  this rank's slice of the output features and computes this rank's
  columns of its output; its input passes through ``copy`` (identity
  forward, a sum of the input's gradient over tp in the backward);
* a row-parallel layer (the attention output projections, the MLP
  down-projections) holds this rank's slice of the input features and
  computes a partial sum of the whole output, which ``reduce`` sums over
  tp (identity backward); its bias, replicated, is added once after it;
* where tp divides a layer's width but not its heads (JAX shards on the
  width alone), the layer ``gather``s q/k/v over tp, runs attention whole
  on every rank and keeps this rank's columns (``scatter``) for the
  row-parallel projection, so each rank still computes the single-device
  result.

The forward collectives (``reduce``, ``gather``) are the dispatcher ops
``aozora::tp_all_reduce`` and ``aozora::tp_all_gather``, so that a by-op
remat policy (``ops/remat.py``) sees them and keeps their outputs: a
recomputed region then runs no collective again. The backward ones run in
autograd functions. On a gloo group CUDA tensors go to the collectives as
they are, as the FSDP collectives of the ``dp`` path do.

A tensor's tp slice is the port's own layout (``cut``/``join``): its
split axis cut into tp equal pieces, except the GEGLU projection
(``.ff.net.0.proj``), whose ``h`` and ``gate`` halves are each cut into tp
pieces, so that a rank computes ``h_i * gelu(gate_i)`` on its own (the JAX
package cuts the concatenated column contiguously and reshards). Saves,
previews and training-state files gather the slices back into the JAX
layout (``parallel/sharding.FSDP``).

``TPConfig`` is what the model functions take: the group, its size, this
rank's index in it and the names of the tensors held as tp slices. One
process, or tp 1, passes None and takes the code without tp.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

# the GEGLU projection: its output is [h | gate], each half cut by tp
HALVED_SUFFIXES = (".ff.net.0.proj.weight", ".ff.net.0.proj.bias")
# replicated tensors inside a tp region: an attention's per-head RMSNorm
# scales see only this rank's heads, so their gradients are partial sums
HEAD_NORM_SUFFIXES = (".q_norm.weight", ".k_norm.weight")


class TPSpec(NamedTuple):
    """One tensor held as tp slices: its whole shape in the port's layout
    and in the JAX package's, its element count, the split axis in each
    layout, and ``parts`` (2: the GEGLU halves, each cut by tp)."""
    shape: tuple
    jax_shape: tuple
    numel: int
    axis: int
    jax_axis: int
    parts: int


def spec_for(name: str, shape: tuple, jax_shape: tuple, jax_axis: int, tp: int) -> TPSpec:
    """The ``TPSpec`` of a tensor that the JAX rules split on ``jax_axis``
    of its JAX layout. Both models' layouts map a linear weight (in, out)
    to (out, in) and keep a vector, so the port's axis is the mirror. A
    GEGLU projection whose halves tp does not divide raises a ValueError
    (no model has one: SDXL_BASE's would need tp >= 1024)."""
    n = int(jax_shape[jax_axis])
    parts = 1
    if name.endswith(HALVED_SUFFIXES):
        if n % (2 * tp):
            raise ValueError(f"{name}: tensor parallelism of {tp} divides the GEGLU "
                             f"projection's {n} columns but not each half's {n // 2}")
        parts = 2
    return TPSpec(tuple(shape), tuple(jax_shape), int(torch.Size(shape).numel()),
                  len(shape) - 1 - jax_axis, jax_axis, parts)


def cut(t: torch.Tensor, axis: int, parts: int, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t``: ``axis`` seen as ``parts`` equal
    parts, each cut into ``size`` pieces, the rank's piece of each part,
    concatenated (a new contiguous tensor)."""
    n = t.shape[axis]
    v = t.unflatten(axis, (parts, size, n // (parts * size)))
    return v.select(axis + 1, rank).flatten(axis, axis + 1).contiguous()


def join(pieces, axis: int, parts: int) -> torch.Tensor:
    """The inverse of ``cut``: the whole tensor from every rank's slice, in
    rank order."""
    stacked = torch.stack([p.unflatten(axis, (parts, p.shape[axis] // parts))
                           for p in pieces], dim=axis + 1)
    return stacked.flatten(axis, axis + 2)


def block_ids(spec: TPSpec, size: int, rank: int, block: int, device) -> torch.Tensor:
    """The int8 block (over the whole tensor's flat JAX order, ``block``
    elements each) of every element of rank ``rank``'s slice, in the
    slice's own flat JAX order."""
    index = torch.arange(spec.numel, device=device).view(spec.jax_shape)
    return cut(index, spec.jax_axis, spec.parts, size, rank).view(-1) // block


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

# the dispatcher ops name their group by a key into this table; it holds
# no config alive (a backward keeps its own on its context)
_GROUPS: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_KEYS = itertools.count(1)


class TPConfig:
    """The tp group of this rank as the model functions see it: ``size``
    ranks, this one ``rank``, and ``names``, the tensors held as tp
    slices. ``stats`` counts the bytes this rank put into tp collectives,
    by kind ("reduce", "gather", "copy", "scatter")."""

    def __init__(self, group, size: int, rank: int, names=()):
        self.group, self.size, self.rank = group, int(size), int(rank)
        self.names = frozenset(names)
        self.stats: dict = {}
        self.key = next(_KEYS)
        _GROUPS[self.key] = self

    def splits(self, name: str) -> bool:
        """Whether ``name`` is held as a tp slice."""
        return name in self.names

    def count(self, kind: str, t: torch.Tensor) -> None:
        self.stats[kind] = self.stats.get(kind, 0) + t.numel() * t.element_size()

    # the four functions of a tp region, on activations of shape (..., C)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a column-parallel layer's input: the identity forward,
        its gradient summed over tp in the backward."""
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's partial output summed over tp (identity
        backward)."""
        return torch.ops.aozora.tp_all_reduce(x, self.key)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's columns of a column-parallel output, whole, in rank
        order (the backward keeps this rank's columns of the gradient)."""
        return torch.ops.aozora.tp_all_gather(x, self.key)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a whole activation, for a row-parallel
        layer (the backward gathers the columns' gradients)."""
        return _Scatter.apply(x, self)

    def row(self, x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
        """A row-parallel linear layer on this rank's input columns ``x``:
        the partial product, summed over tp, then the bias once."""
        y = self.reduce(F.linear(x, weight.to(x.dtype)))
        return y if bias is None else y + bias.to(y.dtype)

    # an attention whose q/k/v are column-parallel and whose output
    # projection is row-parallel

    def heads(self, total: int) -> int:
        """The heads a rank runs: its share, or all ``total`` where tp does
        not divide them (``qkv`` then gathers q/k/v)."""
        return total // self.size if total % self.size == 0 else total

    def qkv(self, heads: int, total: int, q, k, v) -> tuple:
        """q, k, v of the ``heads`` a rank runs: its columns, or every
        rank's where it runs all ``total``."""
        if heads == total:
            return self.gather(q), self.gather(k), self.gather(v)
        return q, k, v

    def attention_out(self, heads: int, total: int, o, weight, bias=None) -> torch.Tensor:
        """The row-parallel output projection of the attention output ``o``
        of the ``heads`` a rank ran (this rank's columns of it where it ran
        all ``total``)."""
        return self.row(self.scatter(o) if heads == total else o, weight, bias)


def _all_gather_last(x: torch.Tensor, tp: TPConfig, kind: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty(tp.size * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.view(-1), group=tp.group)
    tp.count(kind, x)
    return torch.cat(out.view(tp.size, *x.shape).unbind(0), dim=-1)


def _own_columns(x: torch.Tensor, tp: TPConfig) -> torch.Tensor:
    width = x.shape[-1] // tp.size
    return x[..., tp.rank * width:(tp.rank + 1) * width].contiguous()


@torch.library.custom_op("aozora::tp_all_reduce", mutates_args=())
def _tp_all_reduce(x: torch.Tensor, key: int) -> torch.Tensor:
    tp = _GROUPS[key]
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=tp.group)
    tp.count("reduce", out)
    return out


@_tp_all_reduce.register_fake
def _(x, key):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _reduce_backward(ctx, grad):
    return grad, None


torch.library.register_autograd("aozora::tp_all_reduce", _reduce_backward)


@torch.library.custom_op("aozora::tp_all_gather", mutates_args=())
def _tp_all_gather(x: torch.Tensor, key: int) -> torch.Tensor:
    return _all_gather_last(x, _GROUPS[key], "gather")


@_tp_all_gather.register_fake
def _(x, key):
    tp = _GROUPS[key]
    return x.new_empty((*x.shape[:-1], x.shape[-1] * tp.size))


def _gather_setup(ctx, inputs, output):
    ctx.tp = _GROUPS[inputs[1]]


def _gather_backward(ctx, grad):
    return _own_columns(grad, ctx.tp), None


torch.library.register_autograd("aozora::tp_all_gather", _gather_backward,
                                setup_context=_gather_setup)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=tp.group)
        tp.count("copy", grad)
        return grad, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _own_columns(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_last(grad, ctx.tp, "scatter"), None


def head_norm_partial(name: str, shapes: dict, split: Any, size: int) -> bool:
    """Whether ``name``, a replicated tensor, gets a partial gradient on
    each tp rank: the per-head RMSNorm scale of an attention whose q/k/v
    are tp slices and whose heads tp divides (it runs this rank's heads
    alone; where tp does not divide them the attention gathers q/k/v and
    the scale sees every head)."""
    if not name.endswith(HEAD_NORM_SUFFIXES):
        return False
    attn = name.rsplit(".", 2)[0]
    q = f"{attn}.q_proj.weight"
    if q not in split or q not in shapes:
        return False
    heads = int(shapes[q][0]) // int(shapes[name][0])
    return heads % size == 0
