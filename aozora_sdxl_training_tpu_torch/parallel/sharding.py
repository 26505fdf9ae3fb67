"""Process groups, the dp x tp / sp / pp layouts and FSDP of a multi-process run.

Counterpart of ``aozora_sdxl_training_tpu/parallel/sharding.py`` for both
trainers. The JAX package lays a ``jax.sharding.Mesh`` over the devices of
one process; here the devices are the ranks of a ``torchrun`` world
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; one GPU each, or one CPU process
each under ``AOZORA_PLATFORM=cpu`` with the ``gloo`` backend):

* ``resolve_mesh_layout`` takes the JAX function's decisions, fallbacks and
  messages word for word, over ranks instead of devices;
* ``make_mesh`` builds the process groups of a dp x tp, dp x sp or dp x
  pp layout (rank = dp_index * tp + tp_index, and the same for sp and pp:
  the JAX mesh's row-major order);
* ``tp_param_spec`` is the JAX package's Megatron rule word for word: the
  tensors it splits over tp (on the JAX layout's shape) are held as this
  rank's tp slice (``parallel/tensor_parallel.py``);
* ``init_distributed`` / ``destroy_distributed`` start and end the
  process group of a run;
* ``FSDP`` shards the tensors that the JAX package's
  ``param_partition_spec`` shards over dp (``shards_over_dp``: 2^16
  elements or more and an axis that dp divides) and holds the collectives
  of a training step over them: the gather of each compute copy, the
  bucketed reduce-scatter of gradients into the sharded accumulators, the
  bucketed all-reduce of the replicated tensors' gradients and the global
  gradient norm. Under pipeline parallelism (``parallel/pipeline.py``) it
  also keeps each stage-stacked block leaf (``__stack__.<suffix>``) as this
  rank's stage slice, never sharded over dp (the JAX package gives them
  ``P("pp")``), gathers the slices over the pp group for a save or a
  preview, and counts them in the norm once each. Under tensor
  parallelism it keeps each tensor that ``tp_param_spec`` splits as this
  rank's tp slice, never sharded over dp (the JAX package gives it a
  tp-only spec), gathers the slices over the tp group for a save or a
  preview, and sums their squares in the norm over tp.

The shard layout is the port's own: a sharded tensor's elements, in the
JAX package's layout (``to_jax_layout``), are cut into dp contiguous
shards of equal size, a multiple of the int8 moments' 256-element block,
the last one padded with zeros. Whichever axis holds the shards, the
step computes the same numbers; this layout keeps every int8 block whole
on one rank, so a sharded int8 moment holds the whole tensor's codes, and
a gathered moment is already in the training-state file's layout.
"""

from __future__ import annotations

import contextlib
import math
import os
from datetime import timedelta
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..opt.adamw import INT8_BLOCK, AdamWState, Layout, Spread
from . import tensor_parallel as tp_mod
from .pipeline import STACK_PREFIX

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
    """The process groups of a dp x tp, dp x sp or dp x pp layout, seen
    from this rank."""

    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    dp_group: Any    # the dp ranks that share this rank's tp (sp, pp) index
    sp_group: Any    # the sp ranks that share this rank's dp index
    pp: int = 1
    pp_rank: int = 0
    pp_group: Any = None   # the pp stages that share this rank's dp index
    tp: int = 1
    tp_rank: int = 0
    tp_group: Any = None   # the tp ranks that share this rank's dp index


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor axis, as
    ``jax.sharding.PartitionSpec`` holds it."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


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


def _axis_groups(devices: list, dp: int, inner: int, index: int):
    """(dp index, inner index, dp group, inner group) of the rank at
    ``index`` of ``devices`` laid out (dp, inner) row-major: the dp groups
    (one per inner index) and the inner groups (one per dp index), made
    in the same order on every rank."""
    dp_rank, inner_rank = divmod(index, inner)
    dp_group = inner_group = None
    for i in range(inner):                   # the dp groups, one per inner index
        group = dist.new_group([devices[j * inner + i] for j in range(dp)])
        if i == inner_rank:
            dp_group = group
    for j in range(dp):                      # the inner groups, one per dp index
        group = dist.new_group([devices[j * inner + i] for i in range(inner)])
        if j == dp_rank:
            inner_group = group
    return dp_rank, inner_rank, dp_group, inner_group


def make_mesh(devices=None, *, dp: int | None = None, tp: int = 1,
              sp: int = 1, pp: int = 1) -> Mesh:
    """The dp and tp (or sp, or pp) process groups over ``devices`` (global
    ranks; the whole world by default). Every rank of the world must call
    it, in the same order, as ``dist.new_group`` requires. tp, sp and pp
    never combine (``resolve_mesh_layout`` sees to it)."""
    devices = list(devices if devices is not None else range(dist.get_world_size()))
    tp, sp, pp = max(1, int(tp)), max(1, int(sp)), max(1, int(pp))
    if (tp > 1) + (sp > 1) + (pp > 1) > 1:
        raise ValueError(f"tp={tp}, sp={sp} and pp={pp} do not combine")
    dp = dp or len(devices) // (tp * sp * pp)
    if dp * tp * sp * pp > len(devices) or len(devices) % (dp * tp * sp * pp):
        raise ValueError(f"{len(devices)} devices not divisible by "
                         f"dp={dp} x tp={tp} x sp={sp} x pp={pp}")
    index = devices.index(dist.get_rank())
    if pp > 1:
        # GPipe stages: block params stage-stack over pp, everything else
        # replicates over it (parallel/pipeline.py)
        dp_rank, pp_rank, dp_group, pp_group = _axis_groups(devices, dp, pp, index)
        # a first collective on the stage group before its point-to-point
        # hops, which NCCL asks of a group's first use
        dist.barrier(group=pp_group)
        return Mesh(dp, 1, dp_rank, 0, dp_group, None, pp, pp_rank, pp_group)
    if tp > 1:
        # Megatron splits over tp (parallel/tensor_parallel.py); the batch
        # rows and everything tp does not split replicate over it
        dp_rank, tp_rank, dp_group, tp_group = _axis_groups(devices, dp, tp, index)
        return Mesh(dp, 1, dp_rank, 0, dp_group, None, tp=tp, tp_rank=tp_rank,
                    tp_group=tp_group)
    dp_rank, sp_rank, dp_group, sp_group = _axis_groups(devices, dp, sp, index)
    return Mesh(dp, sp, dp_rank, sp_rank, dp_group, sp_group)


def mesh_for(layout: MeshLayout) -> Mesh | None:
    """The process groups of ``layout``, or None on one device."""
    ranks = world_size()
    if ranks != len(layout.devices):
        raise RuntimeError(
            f"WORLD_SIZE={ranks}, but the layout uses {len(layout.devices)} "
            "rank(s) (AOZORA_DEVICES caps it): launch that many processes")
    if not layout.use_mesh:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"WORLD_SIZE={ranks}: the process group is not started; run "
            "through the CLI, which starts it, or call "
            "parallel.sharding.init_distributed() first")
    return make_mesh(layout.devices, dp=layout.dp, tp=layout.tp, sp=layout.sp,
                     pp=layout.pp)


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




# the JAX package's FSDP threshold (``param_partition_spec``'s
# ``min_shard_elements``): smaller tensors stay replicated, their gather
# would cost more in latency than it saves in memory
MIN_SHARD_ELEMENTS = 2 ** 16
# input bytes of one bucketed collective
BUCKET_BYTES = 128 * 2 ** 20


def shards_over_dp(shape, dp: int, min_elements: int = MIN_SHARD_ELEMENTS) -> bool:
    """Whether ``param_partition_spec(shape, dp, "fsdp", min_elements)`` of
    the JAX package shards a tensor of ``shape`` (a spec other than
    ``P()``): dp > 1, at least ``min_elements`` elements, and an axis that
    dp divides. The axis it picks does not matter to the port, which
    shards the flat elements; the condition does not depend on the order
    of the axes, so the port's layout and the JAX package's give the same
    answer."""
    if dp <= 1 or math.prod(shape) < min_elements:
        return False
    return any(int(d) % dp == 0 for d in shape)


# Megatron-style rules keyed on parameter-name suffixes: column-parallel
# layers shard output features (attention heads / GEGLU columns),
# row-parallel layers shard input features so GSPMD closes each pair with
# one psum on the layer output.
_TP_COLUMN_SUFFIXES = (
    # SDXL UNet transformer blocks
    ".to_q.weight", ".to_k.weight", ".to_v.weight", ".ff.net.0.proj.weight",
    # Anima DiT blocks + LLM adapter ((in, out) layout throughout)
    ".q_proj.weight", ".k_proj.weight", ".v_proj.weight",
    ".mlp.layer1.weight", ".mlp.0.weight",
)
_TP_COLUMN_BIAS_SUFFIXES = (".to_q.bias", ".to_k.bias", ".to_v.bias",
                            ".ff.net.0.proj.bias",
                            ".q_proj.bias", ".k_proj.bias", ".v_proj.bias",
                            ".mlp.0.bias")
_TP_ROW_SUFFIXES = (".to_out.0.weight", ".ff.net.2.weight",
                    ".output_proj.weight", ".o_proj.weight",
                    ".mlp.layer2.weight", ".mlp.2.weight")


def tp_param_spec(name: str, shape: tuple[int, ...], tp_size: int) -> P | None:
    """TP spec for one named parameter, or None if the TP rules don't apply."""
    if tp_size <= 1:
        return None
    if name.endswith(_TP_COLUMN_SUFFIXES) and len(shape) == 2 \
            and shape[1] % tp_size == 0:
        return P(None, "tp")
    if name.endswith(_TP_COLUMN_BIAS_SUFFIXES) and len(shape) == 1 \
            and shape[0] % tp_size == 0:
        return P("tp")
    if name.endswith(_TP_ROW_SUFFIXES) and len(shape) == 2 \
            and shape[0] % tp_size == 0:
        return P("tp", None)
    return None


def _touched_blocks(start: int, size: int) -> tuple:
    """(first block, block count) of the int8 blocks that ``size``
    elements from flat element ``start`` touch."""
    return start // INT8_BLOCK, -(-(start % INT8_BLOCK + size) // INT8_BLOCK)


class StageSpec(NamedTuple):
    """One stage-stacked block leaf under pipeline parallelism: the whole
    leaf's shape ([num_blocks, ...]) in the port's layout and in the JAX
    package's, its element count, and this stage's slice: its first block,
    its blocks, and its first element and element count in the whole
    leaf's flat order (the same in both layouts: they differ within a
    block only)."""
    shape: tuple
    jax_shape: tuple
    numel: int
    first: int
    blocks: int
    offset: int
    size: int


class ShardSpec(NamedTuple):
    """One sharded tensor: its shape in the port's layout and in the JAX
    package's, its element count and the elements of each rank's shard."""
    shape: tuple
    jax_shape: tuple
    numel: int
    size: int


class FSDP:
    """The sharded training state of one rank of a dp x sp mesh, and the
    collectives of a step over it.

    ``shapes`` names every tensor of the model (trainable and frozen) with
    its shape in the port's layout; those that ``shards_over_dp`` picks
    are kept as this rank's flat shard (``shard``), the rest whole on
    every rank. ``layout`` is the model's (``to_jax_layout`` /
    ``from_jax_layout``). The dp ranks of one sp index share the shards;
    the sp ranks of one dp index hold the same ones.

    A step: ``compute_copies`` gathers each sharded tensor once (in the
    compute dtype where it has two or more dimensions, in its own dtype
    otherwise: the JAX package's ``precast_params``) and hands the
    replicated tensors through; after the backward, ``reduce_scatter``
    sums the compute copies' gradients over dp into the shards' ``.grad``
    (the accumulators, in the masters' dtype) and frees them; before the
    update, ``sync`` averages the shards' gradients over sp and sums the
    replicated tensors' gradients over the world, divided by sp (each
    dp rank's loss is its share of the global batch's; the sp ranks
    computed the same gradient); ``grad_norm`` is the global norm with
    each replicated tensor counted once.

    Under tensor parallelism (``mesh.tp`` > 1) the tensors that
    ``tp_param_spec`` splits, on their JAX-layout shape, are held as this
    rank's tp slice (``tps``; never also sharded over dp), with their
    accumulators and moments; the rest follow the dp rule over the dp
    group of this rank's tp index. A step computes on the slices as they
    are (``tp_config``, the model functions' ``TPConfig``); ``sync`` sums the
    slices' and the replicated tensors' gradients over the dp group, and
    the per-head norm scales that see only this rank's heads
    (``tp_partial``) over the whole world; ``grad_norm`` sums the slices'
    squares over tp.

    Every collective runs on every rank in the same order: callers gather
    on all ranks (a save or a preview too) and decide on rank 0's word.
    ``stats`` counts the bytes this rank put into each kind of collective,
    by what called it: the step's ("step"), a save's or a preview's."""

    def __init__(self, mesh: Mesh, shapes: dict, layout: Layout, compute_dtype, *,
                 min_elements: int | None = None, bucket_bytes: int = BUCKET_BYTES):
        self.dp, self.rank, self.group = mesh.dp, mesh.dp_rank, mesh.dp_group
        self.sp, self.sp_group = mesh.sp, mesh.sp_group
        self.pp, self.pp_rank, self.pp_group = mesh.pp, mesh.pp_rank, mesh.pp_group
        self.tp, self.tp_rank, self.tp_group = mesh.tp, mesh.tp_rank, mesh.tp_group
        self.layout, self.compute_dtype = layout, compute_dtype
        self.bucket_bytes = int(bucket_bytes)
        min_elements = MIN_SHARD_ELEMENTS if min_elements is None else int(min_elements)
        block = self.dp * INT8_BLOCK
        self.specs, self.stages, self.tps = {}, {}, {}
        for name, shape in shapes.items():
            shape = tuple(int(d) for d in shape)
            tp_spec = None
            if self.tp > 1 and len(shape) <= 2:
                jax_shape = tuple(layout.to_jax(name, torch.empty(shape, device="meta")).shape)
                tp_spec = tp_param_spec(name, jax_shape, self.tp)
            if tp_spec is not None:
                self.tps[name] = tp_mod.spec_for(name, shape, jax_shape,
                                                 tp_spec.index("tp"), self.tp)
            elif name.startswith(STACK_PREFIX):
                # a stacked block leaf never shards over dp; under pp each
                # rank keeps its stage's blocks
                if self.pp > 1:
                    blocks = shape[0] // self.pp
                    n, per = math.prod(shape), math.prod(shape[1:])
                    jax_shape = tuple(layout.to_jax(name, torch.empty(shape, device="meta")).shape)
                    self.stages[name] = StageSpec(
                        shape, jax_shape, n, self.pp_rank * blocks, blocks,
                        self.pp_rank * blocks * per, blocks * per)
            elif shards_over_dp(shape, self.dp, min_elements):
                n = math.prod(shape)
                jax_shape = tuple(layout.to_jax(name, torch.empty(shape, device="meta")).shape)
                self.specs[name] = ShardSpec(shape, jax_shape, n, -(-n // block) * INT8_BLOCK)
        self.tp_partial = frozenset(
            name for name in shapes
            if name not in self.tps and tp_mod.head_norm_partial(name, shapes, self.tps, self.tp))
        # the model functions' view of the tp group (None without tp)
        self.tp_config = (tp_mod.TPConfig(self.tp_group, self.tp, self.tp_rank, self.tps)
                          if self.tp > 1 else None)
        # the layout alone (shard, opt_layout) needs no process group
        self.backend = (dist.get_backend(self.tp_group if self.tp > 1 else self.group)
                        if dist.is_initialized() else None)
        self.stats: dict = {}
        self.micro_steps = self.optimizer_steps = 0

    def _count(self, what: str, t: torch.Tensor) -> None:
        self.stats[what] = self.stats.get(what, 0) + t.numel() * t.element_size()

    # ---- layout ----

    def opt_layout(self) -> Layout:
        """The optimizer's layout: a sharded tensor's moments are already
        in the JAX package's (flat) order, and its int8 decision is made on
        the whole tensor's element count. A stage slice's int8 decision is
        made on the whole stacked leaf's count too, and its blocks are the
        whole leaf's (``Layout.part``): a slice that starts inside a block
        shares that block's scale with the stage before it."""
        base, specs, stages, tps = self.layout, self.specs, self.stages, self.tps

        def numel(name, t):
            spec = specs.get(name) or stages.get(name) or tps.get(name)
            return spec.numel if spec is not None else t.numel()

        def spread(name):
            spec = tps.get(name)
            if spec is None:
                return None
            return Spread(-(-spec.numel // INT8_BLOCK),
                          lambda device: tp_mod.block_ids(spec, self.tp, self.tp_rank,
                                                          INT8_BLOCK, device),
                          self._merge_tp_amax)

        def part(name):
            spec = stages.get(name)
            if spec is None:
                return 0, None
            aligned = spec.size % INT8_BLOCK == 0
            return spec.offset % INT8_BLOCK, (None if aligned else
                                              lambda amax: self._merge_amax(spec, amax))
        return Layout(
            lambda name, t: t if name in specs else base.to_jax(name, t),
            lambda name, t: t if name in specs else base.from_jax(name, t),
            numel, part, spread)

    def _merge_tp_amax(self, amax: torch.Tensor) -> torch.Tensor:
        """The whole blocks' maxima from every tp slice's (an all-gather
        over the tp group, then the maximum)."""
        every = torch.empty(self.tp * amax.numel(), dtype=amax.dtype, device=amax.device)
        dist.all_gather_into_tensor(every, amax.contiguous(), group=self.tp_group)
        self._count("apply.tp_int8_amax", amax)
        return every.view(self.tp, -1).amax(dim=0)

    def _merge_amax(self, spec: StageSpec, amax: torch.Tensor) -> torch.Tensor:
        """The whole blocks' maxima from this stage's part (``amax``, one
        a block it touches): its first and last block take the maxima of
        every stage that touches them (an all-gather over the pp group)."""
        ends = torch.stack([amax[0], amax[-1]]).float()
        every = torch.empty(2 * self.pp, dtype=ends.dtype, device=ends.device)
        dist.all_gather_into_tensor(every, ends, group=self.pp_group)
        every = every.view(self.pp, 2)
        spans = []
        for j in range(self.pp):
            first, count = _touched_blocks(j * spec.size, spec.size)
            spans.append((first, first + count - 1))
        mine = spans[self.pp_rank]
        out = amax.clone()
        for at, block in ((0, mine[0]), (-1, mine[1])):
            for j, (first, last) in enumerate(spans):
                for end, b in ((0, first), (1, last)):
                    if b == block:
                        out[at] = torch.maximum(out[at], every[j, end].to(out.dtype))
        return out

    # ---- pipeline stages ----

    def stage_slice(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This stage's blocks of a whole stacked leaf (either layout: the
        leading axis is the blocks'), a new tensor."""
        spec = self.stages[name]
        return whole[spec.first:spec.first + spec.blocks].clone()

    def stage_int8(self, name: str, codes: torch.Tensor, scales: torch.Tensor):
        """This stage's (codes, scales) of an int8 moment held whole: its
        blocks' codes and the scales of the int8 blocks they touch."""
        b0, nb = _touched_blocks(self.stages[name].offset, self.stages[name].size)
        return self.stage_slice(name, codes), scales[b0:b0 + nb].clone()

    def gather_stages(self, name: str, part: torch.Tensor, kind: str = "save") -> torch.Tensor:
        """The whole stacked leaf from every stage's slice (in the slice's
        layout and dtype), over the pp group."""
        spec = self.stages[name]
        part = part.contiguous()
        out = torch.empty((self.pp * part.shape[0], *part.shape[1:]), dtype=part.dtype,
                          device=part.device)
        dist.all_gather_into_tensor(out, part, group=self.pp_group)
        self._count(f"{kind}.stage_all_gather", part)
        return out.view(spec.shape[0], *part.shape[1:])

    def gather_stages_int8(self, name: str, codes: torch.Tensor, scales: torch.Tensor):
        """(codes in the JAX layout, scales) of a stacked int8 moment, whole."""
        spec = self.stages[name]
        whole = self.gather_stages(name, codes)
        width = -(-(INT8_BLOCK - 1 + spec.size) // INT8_BLOCK)   # the most a stage touches
        mine = torch.zeros(width, dtype=scales.dtype, device=scales.device)
        mine[:scales.numel()] = scales
        every = torch.empty(self.pp * width, dtype=scales.dtype, device=scales.device)
        dist.all_gather_into_tensor(every, mine, group=self.pp_group)
        self._count("save.stage_all_gather", mine)
        out = torch.empty(-(-spec.numel // INT8_BLOCK), dtype=scales.dtype,
                          device=scales.device)
        for j, row in enumerate(every.view(self.pp, width)):
            b0, nb = _touched_blocks(j * spec.size, spec.size)
            out[b0:b0 + nb] = row[:nb]
        return whole, out

    # ---- tensor-parallel slices ----

    def tp_slice(self, name: str, whole: torch.Tensor, jax: bool = False) -> torch.Tensor:
        """This rank's tp slice of a whole tensor (in the port's layout, or
        the JAX package's with ``jax``), a new tensor."""
        spec = self.tps[name]
        return tp_mod.cut(whole, spec.jax_axis if jax else spec.axis, spec.parts,
                          self.tp, self.tp_rank)

    def gather_tp(self, name: str, part: torch.Tensor, kind: str = "save",
                  jax: bool = False) -> torch.Tensor:
        """The whole tensor from every tp rank's slice (both in the port's
        layout, or the JAX package's with ``jax``), over the tp group."""
        spec = self.tps[name]
        part = part.contiguous()
        every = torch.empty(self.tp * part.numel(), dtype=part.dtype, device=part.device)
        dist.all_gather_into_tensor(every, part.view(-1), group=self.tp_group)
        self._count(f"{kind}.tp_all_gather", part)
        return tp_mod.join(list(every.view(self.tp, *part.shape).unbind(0)),
                           spec.jax_axis if jax else spec.axis, spec.parts)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full`` (the port's layout), a new flat
        tensor on ``full``'s device and in its dtype."""
        spec = self.specs[name]
        flat = self.layout.to_jax(name, full).reshape(-1)
        start = min(self.rank * spec.size, spec.numel)
        piece = flat[start:min(start + spec.size, spec.numel)]
        out = torch.zeros(spec.size, dtype=full.dtype, device=full.device)
        out[:piece.numel()] = piece
        return out

    def shard_int8(self, name: str, codes: torch.Tensor, scales: torch.Tensor):
        """This rank's (codes, scales) of an int8 moment held whole (codes
        in the JAX layout): the blocks of its shard, whole."""
        spec = self.specs[name]
        flat = codes.reshape(-1)
        start = min(self.rank * spec.size, spec.numel)
        piece = flat[start:min(start + spec.size, spec.numel)]
        out = torch.zeros(spec.size, dtype=codes.dtype, device=codes.device)
        out[:piece.numel()] = piece
        nb, b0 = spec.size // INT8_BLOCK, start // INT8_BLOCK
        s_piece = scales[b0:min(b0 + nb, scales.numel())]
        s_out = torch.full((nb,), 1e-30, dtype=scales.dtype, device=scales.device)
        s_out[:s_piece.numel()] = s_piece
        return out, s_out

    def shard_params(self, params: dict) -> dict:
        """``params`` with each sharded tensor replaced by this rank's shard
        (the whole tensor dropped at once), keeping ``requires_grad``."""
        for name in list(params):
            if name in self.specs or name in self.stages or name in self.tps:
                full = params.pop(name)
                cut = (self.shard(name, full.detach()) if name in self.specs
                       else self.tp_slice(name, full.detach()) if name in self.tps
                       else self.stage_slice(name, full.detach()))
                params[name] = cut.requires_grad_(full.requires_grad)
                del full
        return params

    def shard_state(self, state: AdamWState) -> AdamWState:
        """A training state read whole (``ckpt.train_state.load_train_state``:
        host tensors, float moments in the port's layout, int8 codes in the
        JAX package's) with each sharded tensor's moments cut to this
        rank's shard, in ``opt_layout``."""
        def cut(moments):
            out = {}
            for name, value in moments.items():
                if name in self.tps:
                    # int8 codes (JAX layout) cut, the whole blocks' scales kept
                    out[name] = ((self.tp_slice(name, value[0], jax=True), value[1].clone())
                                 if isinstance(value, tuple) else self.tp_slice(name, value))
                elif name in self.stages:
                    out[name] = (self.stage_int8(name, *value) if isinstance(value, tuple)
                                 else self.stage_slice(name, value))
                elif name not in self.specs:
                    out[name] = value
                elif isinstance(value, tuple):
                    out[name] = self.shard_int8(name, *value)
                else:
                    out[name] = self.shard(name, value)
            return out
        return AdamWState(step=state.step, exp_avg=cut(state.exp_avg),
                          exp_avg_sq=cut(state.exp_avg_sq), layout=self.opt_layout())

    @torch.no_grad()
    def held(self, params: dict, opt_state: AdamWState) -> list:
        """Each rank's (sharded tensors' elements, all parameter elements,
        moment bytes, device bytes allocated, stage-stacked elements, tp
        slice elements) as it holds them now, from every rank of the world
        (a collective)."""
        moment_bytes = sum(t.numel() * t.element_size()
                           for moments in (opt_state.exp_avg, opt_state.exp_avg_sq)
                           for value in moments.values()
                           for t in (value if isinstance(value, tuple) else (value,)))
        device = next(iter(params.values())).device
        allocated = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        mine = torch.tensor(
            [float(sum(p.numel() for n, p in params.items() if n in self.specs)),
             float(sum(p.numel() for p in params.values())), float(moment_bytes),
             float(allocated),
             float(sum(p.numel() for n, p in params.items() if n in self.stages)),
             float(sum(p.numel() for n, p in params.items() if n in self.tps))],
            dtype=torch.float64, device=device)
        out = torch.empty(dist.get_world_size() * 6, dtype=torch.float64, device=device)
        dist.all_gather_into_tensor(out, mine)
        return [tuple(int(x) for x in row) for row in out.view(-1, 6).tolist()]

    def report(self, trainable: dict, frozen: dict, opt_state: AdamWState) -> None:
        """Prints what is sharded and what each rank holds after setup (a
        collective: every rank calls it; the CLI shows rank 0's lines)."""
        params = {**trainable, **frozen}
        held = self.held(params, opt_state)
        sharded = sum(spec.numel for name, spec in self.specs.items() if name in params)
        stacked = sum(spec.numel for name, spec in self.stages.items() if name in params)
        split = sum(spec.numel for name, spec in self.tps.items() if name in params)
        if self.specs or self.stages:
            print(self.describe(trainable, frozen))
            print(f"INFO: FSDP held per rank: sharded elements {[h[0] for h in held]} of "
                  f"{sharded:,} ({', '.join(f'{h[0] / max(sharded, 1):.4f}' for h in held)}); "
                  f"all parameter elements {[h[1] for h in held]}; moment bytes "
                  f"{[h[2] for h in held]}; device bytes allocated {[h[3] for h in held]}")
        if self.tps:
            print(self.describe_tp(trainable, frozen))
            print(f"INFO: Tensor parallel held per rank: split elements {[h[5] for h in held]} "
                  f"of {split:,} ({', '.join(f'{h[5] / max(split, 1):.4f}' for h in held)}); "
                  f"all parameter elements {[h[1] for h in held]}; moment bytes "
                  f"{[h[2] for h in held]}; device bytes allocated {[h[3] for h in held]}")
        if self.stages:
            print(f"INFO: Pipeline stages held per rank: stacked block elements "
                  f"{[h[4] for h in held]} of {stacked:,} "
                  f"({', '.join(f'{h[4] / max(stacked, 1):.4f}' for h in held)})")

    # ---- collectives ----

    def gather_flat(self, name: str, shard: torch.Tensor, kind: str = "save") -> torch.Tensor:
        """The whole tensor's elements in the JAX layout's flat order, from
        every dp rank's shard (a flat tensor of its element count)."""
        spec = self.specs[name]
        out = torch.empty(self.dp * spec.size, dtype=shard.dtype, device=shard.device)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=self.group)
        self._count(f"{kind}.all_gather_into_tensor", shard)
        return out[:spec.numel]

    def gather(self, name: str, shard: torch.Tensor, dtype=None,
               kind: str = "save") -> torch.Tensor:
        """The whole tensor in the port's layout (contiguous), in ``dtype``
        (the shard's by default): the shard is cast before it moves."""
        spec = self.specs[name]
        flat = self.gather_flat(name, shard if dtype is None else shard.to(dtype), kind)
        return self.layout.from_jax(name, flat.view(spec.jax_shape)).contiguous()

    def gather_int8(self, name: str, codes: torch.Tensor, scales: torch.Tensor):
        """(codes in the JAX layout, scales) of a sharded int8 moment,
        whole."""
        spec = self.specs[name]
        whole = self.gather_flat(name, codes).view(spec.jax_shape)
        out = torch.empty(self.dp * scales.numel(), dtype=scales.dtype, device=scales.device)
        dist.all_gather_into_tensor(out, scales.contiguous(), group=self.group)
        self._count("save.all_gather_into_tensor", scales)
        return whole, out[:-(-spec.numel // INT8_BLOCK)]

    def compute_copies(self, params: dict, dtype=None, kind: str = "step") -> dict:
        """Every tensor of ``params`` whole: a sharded one gathered, in
        ``dtype`` or, by default, the compute dtype where it has two or
        more dimensions (for the step: a leaf that requires a gradient
        where its shard does); a replicated one as it is. A stage slice
        stays this stage's for the step, and is gathered over the pp group
        for a save or a preview (the dtype chosen by a block's dimensions)."""
        out = {}
        for name, p in params.items():
            split = self.tps.get(name)
            if split is not None and kind != "step":
                want = dtype or (self.compute_dtype if len(split.shape) >= 2 else p.dtype)
                with torch.no_grad():
                    out[name] = self.gather_tp(name, p.detach().to(want), kind)
                continue
            stage = self.stages.get(name)
            if stage is not None and kind != "step":
                want = dtype or (self.compute_dtype if len(stage.shape) >= 3 else p.dtype)
                with torch.no_grad():
                    out[name] = self.gather_stages(name, p.detach().to(want), kind)
                continue
            spec = self.specs.get(name)
            if spec is None:
                # a replicated tensor, or a tp slice for the step
                out[name] = p
                continue
            want = dtype or (self.compute_dtype if len(spec.shape) >= 2 else p.dtype)
            with torch.no_grad():
                full = self.gather(name, p.detach(), want, kind)
            out[name] = full.requires_grad_(p.requires_grad and kind == "step")
        return out

    def _buckets(self, items):
        """(dtype, [(name, tensor, elements)]) groups of consecutive items
        of one dtype, each of at most ``bucket_bytes`` (an item larger
        than that alone)."""
        bucket, dtype, nbytes = [], None, 0
        for name, t, n in items:
            size = n * t.element_size()
            if bucket and (t.dtype != dtype or nbytes + size > self.bucket_bytes):
                yield dtype, bucket
                bucket, nbytes = [], 0
            bucket.append((name, t, n))
            dtype, nbytes = t.dtype, nbytes + size
        if bucket:
            yield dtype, bucket

    @torch.no_grad()
    def reduce_scatter(self, copies: dict, params: dict) -> None:
        """Sums the gradients of the sharded tensors' compute copies over
        dp into the shards' ``.grad`` (set, or added to what the window
        accumulated so far), by buckets, in the masters' dtype; each copy's
        gradient is freed once it is in a bucket. A copy without a gradient
        counts as zeros, so every rank reduces the same buckets."""
        self.micro_steps += 1
        items = [(name, copies[name], self.dp * self.specs[name].size)
                 for name, p in params.items() if name in self.specs and p.requires_grad]
        for dtype, bucket in self._buckets(items):
            sizes = [self.specs[name].size for name, _, _ in bucket]
            rows = torch.zeros((self.dp, sum(sizes)), dtype=dtype, device=bucket[0][1].device)
            off = 0
            for (name, copy, _), size in zip(bucket, sizes):
                if copy.grad is not None:
                    spec = self.specs[name]
                    flat = torch.zeros(self.dp * size, dtype=dtype, device=rows.device)
                    flat[:spec.numel].view(spec.jax_shape).copy_(
                        self.layout.to_jax(name, copy.grad))
                    copy.grad = None
                    rows[:, off:off + size].copy_(flat.view(self.dp, size))
                off += size
            out = torch.empty(rows.shape[1], dtype=dtype, device=rows.device)
            dist.reduce_scatter_tensor(out, rows.view(-1), group=self.group)
            self._count("step.reduce_scatter_tensor", rows)
            off = 0
            for (name, _, _), size in zip(bucket, sizes):
                p, piece = params[name], out[off:off + size]
                if p.grad is None:
                    p.grad = piece.to(p.dtype, copy=True)
                else:
                    p.grad.add_(piece)
                off += size

    def _all_reduce(self, tensors: list, group) -> None:
        """Sums ``tensors`` in place over ``group``, by buckets."""
        items = [(None, t, t.numel()) for t in tensors]
        for dtype, bucket in self._buckets(items):
            flat = torch.cat([t.reshape(-1) for _, t, _ in bucket])
            dist.all_reduce(flat, group=group)
            self._count("apply.all_reduce", flat)
            off = 0
            for _, t, n in bucket:
                t.copy_(flat[off:off + n].view_as(t))
                off += n

    @torch.no_grad()
    def sync(self, params: dict) -> None:
        """Before the update: the replicated tensors' ``.grad`` summed over
        every rank of the world and the shards' over the sp group, both
        divided by sp. Under pp the replicated tensors' (the stage slices
        among them) are summed over the dp group alone: the stages hold
        other blocks, and the tensors around the stack take the same
        gradient on every stage. Under tp the same holds for the tp slices
        and the replicated tensors (the tp ranks of a dp index train on the
        same rows, and "copy" already summed the gradients of a tp region's
        input), while the partial gradients of ``tp_partial`` are summed
        over the whole world. A missing gradient counts as zeros."""
        self.optimizer_steps += 1
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        replicated = [p.grad for name, p in params.items() if name not in self.specs]
        if self.tp > 1:
            partial = [p.grad for name, p in params.items() if name in self.tp_partial]
            rest = [p.grad for name, p in params.items()
                    if name not in self.specs and name not in self.tp_partial]
            if self.dp > 1:
                self._all_reduce(rest, self.group)
            if partial:
                self._all_reduce(partial, None)
            return
        if self.pp > 1:
            if self.dp > 1:
                self._all_reduce(replicated, self.group)
            return
        self._all_reduce(replicated, None)
        sharded = [p.grad for name, p in params.items() if name in self.specs]
        if self.sp > 1:
            self._all_reduce(sharded, self.sp_group)
        if self.sp > 1:
            for g in replicated + sharded:
                g.div_(self.sp)

    @torch.no_grad()
    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The global L2 norm of ``grads`` (shards, stage slices, tp slices
        and replicated tensors, keyed like the parameters): the shards'
        squares summed over dp, the stage slices' over pp, the tp slices'
        over tp, each replicated tensor once."""
        device = next(iter(grads.values())).device
        sharded = torch.zeros((), dtype=torch.float32, device=device)
        staged = torch.zeros((), dtype=torch.float32, device=device)
        split = torch.zeros((), dtype=torch.float32, device=device)
        replicated = torch.zeros((), dtype=torch.float32, device=device)
        for name, g in grads.items():
            (sharded if name in self.specs else staged if name in self.stages
             else split if name in self.tps else replicated).add_((g.float() ** 2).sum())
        sharded = sharded.reshape(1)
        dist.all_reduce(sharded, group=self.group)
        if self.stages:
            staged = staged.reshape(1)
            dist.all_reduce(staged, group=self.pp_group)
            staged = staged[0]
        if self.tps:
            split = split.reshape(1)
            dist.all_reduce(split, group=self.tp_group)
            split = split[0]
        return torch.sqrt(sharded[0] + staged + split + replicated)

    def describe(self, trainable: dict, frozen: dict) -> str:
        """One line: what is sharded, over which group and backend, and the
        collectives a step takes."""
        def count(params):
            names = [n for n in params if n in self.specs]
            return len(names), sum(self.specs[n].numel for n in names)
        t_n, t_e = count(trainable)
        f_n, f_e = count(frozen)
        stages = ""
        if self.stages:
            spec = next(iter(self.stages.values()))
            stages = (f"; {len(self.stages)} stage-stacked block leaves over pp={self.pp}, this "
                      f"rank holding blocks [{spec.first}, {spec.first + spec.blocks}) of "
                      f"{spec.shape[0]}, never sharded over dp")
        return (f"INFO: FSDP over dp={self.dp} ({self.backend}){stages}: {t_n} trainable tensor(s) "
                f"({t_e:,} elements) and {f_n} frozen ({f_e:,}) sharded, the rest "
                f"replicated; a micro step all-gathers each sharded tensor's compute "
                f"copy ({str(self.compute_dtype).replace('torch.', '')} where 2-D or "
                f"more) and reduce-scatters its gradient (reduce_scatter_tensor, "
                f"buckets of {self.bucket_bytes >> 20} MB); the optimizer step "
                f"all-reduces the replicated gradients in buckets")

    def describe_tp_traffic(self) -> str:
        """One line: the bytes this rank put into the tp collectives of the
        steps, a micro step on average, by kind (a recomputed region's
        collectives counted again)."""
        stats = self.tp_config.stats if self.tp_config is not None else {}
        n = max(self.micro_steps, 1)
        kinds = ", ".join(f"{k} {v / n:,.0f}" for k, v in sorted(stats.items()))
        return (f"INFO: Tensor parallel collectives a micro step on this rank: "
                f"{sum(stats.values()) / n:,.0f} bytes ({kinds}) over {self.micro_steps} "
                f"micro step(s)")

    def describe_tp(self, trainable: dict, frozen: dict) -> str:
        """One line: what is split over tp, over which group and backend,
        and what each rank holds of it."""
        def count(params, column):
            names = [n for n in params if n in self.tps
                     and (self.tps[n].axis == 0) == column]
            return len(names), sum(self.tps[n].numel for n in names)
        parts = []
        for label, params in (("trainable", trainable), ("frozen", frozen)):
            (c_n, c_e), (r_n, r_e) = count(params, True), count(params, False)
            parts.append(f"{c_n} {label} column-parallel tensor(s) ({c_e:,} elements) and "
                         f"{r_n} row-parallel ({r_e:,})")
        held = sum(spec.numel // self.tp for spec in self.tps.values())
        return (f"INFO: Tensor parallelism over tp={self.tp} ({self.backend}, dp={self.dp}): "
                f"{'; '.join(parts)} split Megatron-style, each rank holding 1/{self.tp} "
                f"({held:,} elements) of them, never sharded over dp; the rest follow "
                f"the dp rule; {len(self.tp_partial)} per-head norm scale(s) summed over "
                f"tp; a micro step all-reduces each row-parallel output and each "
                f"column-parallel input's gradient over tp")


def rank0_says(flags: list, device) -> list:
    """Global rank 0's ``flags`` (bools) on every rank: the decisions that
    rank 0 alone can make (the GUI's force-save flag, a preview it alone
    renders) but that start collectives every rank must join."""
    t = torch.tensor([1.0 if f else 0.0 for f in flags], device=device)
    dist.broadcast(t, 0)
    return [bool(x) for x in t.tolist()]
