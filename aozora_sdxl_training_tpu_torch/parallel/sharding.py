"""Process groups and the dp x sp layout of a multi-process training run.

Counterpart of the part of ``aozora_sdxl_training_tpu/parallel/sharding.py``
that the Anima trainer's sequence-parallel path needs. The JAX package
lays a ``jax.sharding.Mesh`` over the devices of one process; here the
devices are the ranks of a ``torchrun`` world (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``; one GPU each, or one CPU process each under
``AOZORA_PLATFORM=cpu`` with the ``gloo`` backend):

* ``resolve_mesh_layout`` takes the JAX function's decisions, fallbacks and
  messages word for word, over ranks instead of devices;
* ``make_mesh`` builds the dp and sp process groups of a dp x sp layout
  (rank = dp_index * sp + sp_index, the JAX mesh's row-major order);
* ``init_distributed`` / ``destroy_distributed`` start and end the
  process group of a run.

Parameters stay replicated on every rank (the JAX default is FSDP, which
gives the same numbers with less memory); FSDP, tensor and pipeline
parallelism are not ported yet.
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

# where the ranks meet: torchrun's MASTER_ADDR/MASTER_PORT by default; the
# tests point it at a file:// store
INIT_METHOD_ENV = "AOZORA_DIST_INIT"


class MeshLayout(NamedTuple):
    """Resolved device layout + batch semantics for a training run.
    ``devices`` are global ranks."""

    devices: tuple
    dp: int
    tp: int
    global_batch: int
    use_mesh: bool
    sp: int = 1   # sequence-parallel degree (Anima DiT ring attention)
    pp: int = 1   # pipeline-parallel degree (Anima DiT GPipe stages)


class Mesh(NamedTuple):
    """The process groups of a dp x sp layout, seen from this rank."""

    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    dp_group: Any    # the dp ranks that share this rank's sp index
    sp_group: Any    # the sp ranks that share this rank's dp index


def world_size() -> int:
    """Ranks of the torchrun world; 1 where ``WORLD_SIZE`` is unset."""
    return max(1, int(os.environ.get("WORLD_SIZE", "1") or 1))


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0") or 0)


def quiet_unless_rank_0():
    """A context that sends stdout to /dev/null on every rank but global
    rank 0, so the GUI reads one set of lines."""
    if global_rank() == 0:
        return contextlib.nullcontext()
    return _silenced()


@contextlib.contextmanager
def _silenced():
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def resolve_mesh_layout(config) -> MeshLayout:
    """Decide dp x tp and the *global* batch for this run.

    ``BATCH_SIZE`` in the config is **per-dp-shard** (the reference is
    single-GPU so its BATCH_SIZE trivially equals both readings). On a mesh
    the global batch becomes ``BATCH_SIZE * dp``.

    ``AOZORA_DEVICES=<n>`` caps the device count (tests / pinning).
    """
    devices = list(range(world_size()))
    limit = int(os.environ.get("AOZORA_DEVICES", "0") or 0)
    if limit > 0:
        devices = devices[:limit]
    tp = max(1, int(getattr(config, "TENSOR_PARALLEL_SIZE", 1) or 1))
    sp = max(1, int(getattr(config, "SEQUENCE_PARALLEL_SIZE", 1) or 1))
    pp = max(1, int(getattr(config, "PIPELINE_PARALLEL_SIZE", 1) or 1))
    if sp > 1 and tp > 1:
        print("WARNING: SEQUENCE_PARALLEL_SIZE and TENSOR_PARALLEL_SIZE "
              "cannot combine (both shard attention); falling back to tp=1.")
        tp = 1
    if pp > 1 and (tp > 1 or sp > 1):
        print("WARNING: PIPELINE_PARALLEL_SIZE cannot combine with "
              "TENSOR/SEQUENCE_PARALLEL_SIZE; falling back to tp=1, sp=1.")
        tp = sp = 1
    if len(devices) % tp != 0:
        print(f"WARNING: TENSOR_PARALLEL_SIZE={tp} does not divide "
              f"{len(devices)} device(s); falling back to tp=1.")
        tp = 1
    if len(devices) % sp != 0:
        print(f"WARNING: SEQUENCE_PARALLEL_SIZE={sp} does not divide "
              f"{len(devices)} device(s); falling back to sp=1.")
        sp = 1
    if len(devices) % pp != 0:
        print(f"WARNING: PIPELINE_PARALLEL_SIZE={pp} does not divide "
              f"{len(devices)} device(s); falling back to pp=1.")
        pp = 1
    dp = max(1, len(devices) // (tp * sp * pp))
    per_shard = int(config.BATCH_SIZE)
    global_batch = per_shard * dp
    use_mesh = len(devices) > 1
    if dp > 1 or sp > 1 or pp > 1:
        print(f"INFO: BATCH_SIZE={per_shard} is per-dp-shard: global batch "
              f"= {per_shard} x dp{dp} = {global_batch} "
              f"(mesh dp={dp} x tp={tp} x sp={sp} x pp={pp} over "
              f"{dp * tp * sp * pp} device(s)).")
    return MeshLayout(tuple(devices[: dp * tp * sp * pp]), dp, tp,
                      global_batch, use_mesh, sp, pp)


def make_mesh(devices=None, *, dp: int | None = None, tp: int = 1,
              sp: int = 1, pp: int = 1) -> Mesh:
    """The dp and sp process groups over ``devices`` (global ranks; the
    whole world by default). Every rank of the world must call it, in the
    same order, as ``dist.new_group`` requires."""
    devices = list(devices if devices is not None else range(dist.get_world_size()))
    tp, sp, pp = max(1, int(tp)), max(1, int(sp)), max(1, int(pp))
    if tp > 1 or pp > 1:
        raise NotImplementedError(
            "TENSOR/PIPELINE_PARALLEL_SIZE > 1 is not ported to the PyTorch "
            "package yet (only dp x sp)")
    dp = dp or len(devices) // sp
    if dp * sp > len(devices) or len(devices) % (dp * sp):
        raise ValueError(f"{len(devices)} devices not divisible by "
                         f"dp={dp} x tp={tp} x sp={sp} x pp={pp}")
    rank = dist.get_rank()
    index = devices.index(rank)
    dp_rank, sp_rank = divmod(index, sp)
    dp_group = sp_group = None
    for i in range(sp):                      # the dp groups, one per sp index
        group = dist.new_group([devices[j * sp + i] for j in range(dp)])
        if i == sp_rank:
            dp_group = group
    for j in range(dp):                      # the sp groups, one per dp index
        group = dist.new_group([devices[j * sp + i] for i in range(sp)])
        if j == dp_rank:
            sp_group = group
    return Mesh(dp, sp, dp_rank, sp_rank, dp_group, sp_group)


def init_distributed() -> torch.device | None:
    """Starts the process group of a torchrun world and returns this rank's
    device; None (and nothing started) where ``WORLD_SIZE`` is unset or 1.

    ``AOZORA_PLATFORM=cpu`` takes ``gloo`` and the CPU; otherwise ``nccl``
    on ``cuda:LOCAL_RANK``, and no CUDA device is an error, as for one
    process. The ranks meet at ``AOZORA_DIST_INIT`` (a ``file://`` or
    ``tcp://`` URL), else at torchrun's ``MASTER_ADDR``/``MASTER_PORT``
    (``env://``). Under torchrun leave ``AOZORA_DIST_INIT`` unset: there
    torchrun's agent serves the store, and no rank would serve a
    ``tcp://`` one."""
    size = world_size()
    if size == 1 or dist.is_initialized():
        return None
    rank = int(os.environ["RANK"])
    init_method = os.environ.get(INIT_METHOD_ENV) or "env://"
    platform = os.environ.get("AOZORA_PLATFORM", "").strip().lower()
    if platform == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        from ..core.platform import resolve_device
        resolve_device()                       # raises without CUDA
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0") or 0))
        torch.cuda.set_device(device)
        backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=size,
                            rank=rank, timeout=timedelta(minutes=30))
    return device


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@torch.no_grad()
def all_reduce_grads(params: dict, sp: int) -> None:
    """Sums the ``.grad`` of ``params`` over every rank and divides by
    ``sp``: the dp shards' gradients add (each rank's loss is its share of
    the global batch's), and the sp replicas, which computed the same
    gradient, are averaged, which also keeps them equal where atomics
    summed in another order. A missing gradient counts as zeros, so every
    rank reduces the same tensors in the same order."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad)
        if sp > 1:
            p.grad.div_(sp)
