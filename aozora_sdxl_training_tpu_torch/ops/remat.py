"""Selective rematerialization: value names and the policies that read them.

The JAX package chooses what a ``jax.checkpoint`` region keeps by policy:
by primitive (``dots_saveable``: every ``dot_general`` and convolution
output) or by name (``jax.ad_checkpoint.checkpoint_name``, read by
``save_only_these_names``). The port runs the same regions through
``torch.utils.checkpoint``. Torch replays a checkpointed region op by op in
the backward and, unlike JAX's partial evaluation, cannot drop an op whose
output a kept value covers: the code that makes a named value has to skip
its work itself. So:

* ``checkpoint_name(x, name)`` is the identity op ``aozora::checkpoint_name``
  (an alias of ``x``, no copy), the counterpart of JAX's.
* By-op policies (``dots``, ``dots_no_batch``, ``dots_no_logits``, JAX's
  ``dots_except_attention_logits``) run under torch's selective
  checkpointing, whose dispatch mode sees each op: JAX's ``dot_general``
  is ``mm``/``addmm``/``bmm``/``baddbmm`` here (the ops ``F.linear`` and
  ``torch.einsum`` reach), its convolution (the forward of ``ops/conv.py``
  is ``lax.conv_general_dilated``) ``aten.convolution``. A named value's
  maker runs inside ``producing(name)``; a policy that saves the name
  keeps the outputs of the ops run there (views excluded).
* The name-only policy ``conservative`` (the DiT's
  ``save_only_these_names("mlp_down", "flash_out", "flash_lse")``) runs
  without a dispatch mode: the region's forward keeps each named value as
  ``kept`` makes it, and its recompute hands the value back to the code
  that made it, which skips its work but still records the inputs its
  backward needs. A dispatch mode costs each op of the region a Python
  call twice (forward and recompute); on the host-bound eager step that
  cost more than the recompute it saves (``PERF.md``).

Under tensor parallelism a region holds collectives: the forward ones
(``aozora::tp_all_reduce`` after a row-parallel GEMM,
``aozora::tp_all_gather`` of a head-cut layer's q/k/v;
``parallel/tensor_parallel.py``) are dispatcher ops that every by-op
policy keeps, so the recompute never runs them again and never replays a
kept pre-reduce GEMM output without its reduce. A fully recomputed region
runs them again, in the same order on every rank; the Conservative policy
keeps "mlp_down" after its reduce (``linear_kept`` with ``tp``).

``remat(fn, mode, *args)`` runs ``fn(*args)`` as one region: everything
recomputed (``True``/``"full"``), or what ``mode``'s policy keeps.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# the op's library must live as long as the process: its registrations go
# with it
_LIB = torch.library.Library("aozora", "FRAGMENT")
_LIB.define("checkpoint_name(Tensor(a) x, str name) -> Tensor(a)")


def _alias(x, name):
    return torch.ops.aten.alias.default(x)


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        with torch._C._AutoDispatchBelowAutograd():
            return torch.ops.aozora.checkpoint_name(x, name)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


_LIB.impl("checkpoint_name", _alias, "CompositeExplicitAutograd")
_LIB.impl("checkpoint_name", _Identity.apply, "Autograd")


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, named ``name`` for a remat policy (an alias: no copy)."""
    return torch.ops.aozora.checkpoint_name(x, name)


_SCOPE = threading.local()


@contextlib.contextmanager
def producing(*names: str):
    """The ops run inside make the values named ``names``: a policy that
    saves one of the names keeps their outputs."""
    outer = getattr(_SCOPE, "names", frozenset())
    _SCOPE.names = outer | frozenset(names)
    try:
        yield
    finally:
        _SCOPE.names = outer


def _names(op, args) -> frozenset:
    """The names that an op call's outputs carry."""
    if op is torch.ops.aozora.checkpoint_name.default:
        return frozenset((args[1],))
    if any(r.alias_info is not None for r in op._schema.returns):
        return frozenset()          # a view: its base is what a policy keeps
    return getattr(_SCOPE, "names", frozenset())


_NO_BATCH_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
_BATCH_DOTS = {torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}
_DOTS = _NO_BATCH_DOTS | _BATCH_DOTS
_CONVS = {torch.ops.aten.convolution.default}


def _dot_out_shape(op, args) -> tuple:
    """Output shape of a dot op from its operands' shapes."""
    a, b = (args[1], args[2]) if op in (torch.ops.aten.addmm.default,
                                        torch.ops.aten.baddbmm.default) else args[:2]
    return (*a.shape[:-1], b.shape[-1])


def _big_square(op, args) -> bool:
    """An attention logit matrix: last two dims equal, >= 2^20 elements."""
    shape = _dot_out_shape(op, args)
    return shape[-1] == shape[-2] and shape[-1] * shape[-2] >= (1 << 20)


# the forward collectives of tensor parallelism, kept by every by-op policy
_TP_COLLECTIVES = frozenset(("aozora::tp_all_reduce", "aozora::tp_all_gather"))


def _policy(save):
    """A torch selective-checkpoint policy from ``save(op, args) -> bool``."""
    def policy(ctx, op, *args, **kwargs):
        keep = save(op, args) or (hasattr(op, "name") and op.name() in _TP_COLLECTIVES)
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def dots_saveable(op, args) -> bool:
    """JAX's ``dots_saveable``: every dot and convolution output."""
    return op in _DOTS or op in _CONVS


def dots_with_no_batch_dims_saveable(op, args) -> bool:
    """JAX's ``dots_with_no_batch_dims_saveable``: dots without batch
    dimensions (the linear layers' ``mm``/``addmm``)."""
    return op in _NO_BATCH_DOTS


def dots_except_attention_logits(op, args) -> bool:
    """The JAX package's policy of the same name: every dot and conv
    output except the big square attention logits, and the flash kernel's
    (out, lse) by name, so that its backward goes straight to the dQ and
    dK/dV kernels."""
    if _names(op, args) & {"flash_out", "flash_lse"}:
        return True
    if op in _DOTS:
        return not _big_square(op, args)
    return dots_saveable(op, args)


POLICIES = {
    "dots": _policy(dots_saveable),
    "dots_no_batch": _policy(dots_with_no_batch_dims_saveable),
    "dots_no_logits": _policy(dots_except_attention_logits),
}
# name-only policies: the names each keeps
NAMED = {"conservative": frozenset(("mlp_down", "flash_out", "flash_lse"))}


class _Kept:
    """The named values one region keeps: appended in the forward, handed
    back in the same order in the recompute."""

    def __init__(self, names: frozenset):
        self.names = names
        self.values: list = []
        self.replay = None

    @contextlib.contextmanager
    def recompute(self):
        self.replay = iter(self.values)
        with _active(self):
            yield


@contextlib.contextmanager
def _active(region):
    outer = getattr(_SCOPE, "kept", None)
    _SCOPE.kept = region
    try:
        yield
    finally:
        _SCOPE.kept = outer


def kept(names: tuple, make):
    """``make(cached)`` makes the values named ``names`` (a tensor or a
    tuple of tensors). Outside a region whose name-only policy keeps one of
    the names, or in its forward, ``cached`` is None and ``make`` computes;
    the forward keeps what it returns. In the region's recompute ``cached``
    is what the forward kept, and ``make`` returns it in place of computing
    (recording, as before, the inputs its backward needs)."""
    region = getattr(_SCOPE, "kept", None)
    if region is None or not region.names & frozenset(names):
        return make(None)
    if region.replay is not None:
        return make(next(region.replay))
    out = make(None)
    region.values.append(tuple(t.detach() for t in out) if isinstance(out, tuple)
                         else out.detach())
    return out


def policy(mode):
    """The by-op selective policy of a remat mode, or None to recompute all
    (``True``/``"full"``). Raises on a mode the JAX package does not have."""
    if mode is True or mode == "full":
        return None
    if mode not in POLICIES:
        raise ValueError(f"remat mode {mode!r}; expected False, True, 'full' "
                         f"or one of {sorted(POLICIES) + sorted(NAMED)}")
    return POLICIES[mode]


def remat(fn, mode, *args, **kwargs):
    """``fn(*args, **kwargs)``, as one checkpointed region under ``mode``
    (False/None: not checkpointed)."""
    if not mode:
        return fn(*args, **kwargs)
    if mode in NAMED:
        region = _Kept(NAMED[mode])
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (_active(region), region.recompute()),
                          **kwargs)
    chosen = policy(mode)
    extra = ({"context_fn": functools.partial(create_selective_checkpoint_contexts, chosen)}
             if chosen is not None else {})
    return checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)


class _Linear(torch.autograd.Function):
    """y = x w^T from ``linear_kept``: computed, or the kept y; the backward
    needs x and w either way."""

    @staticmethod
    def forward(ctx, x, w, cached):
        ctx.save_for_backward(x, w)
        return F.linear(x, w) if cached is None else cached

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gw = grad.reshape(-1, grad.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return grad @ w, gw, None


def linear_kept(x: torch.Tensor, w: torch.Tensor, name: str, tp=None) -> torch.Tensor:
    """``F.linear(x, w)`` (no bias), named ``name``: a region whose policy
    keeps the name keeps the output, and its recompute skips the GEMM.
    ``tp`` (a ``TPConfig``): a row-parallel layer, whose output is kept
    after its sum over tp, so the recompute skips the sum too (the sum's
    backward is the identity: both graphs give x and w one gradient)."""
    def make(cached):
        y = _Linear.apply(x, w, cached)
        return y if tp is None or cached is not None else tp.reduce(y)

    out = kept((name,), make)
    return checkpoint_name(out, name)
