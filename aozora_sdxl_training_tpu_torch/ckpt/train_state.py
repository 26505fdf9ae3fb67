"""Training-state checkpointing (optimizer moments, counters, sampler state).

Counterpart of ``aozora_sdxl_training_tpu/ckpt/train_state.py``, in its
format, so that a state saved by either package resumes in the other: one
safetensors file holding ``opt.step`` (int32, 0-d), ``m.<param>`` /
``v.<param>`` for each moment (an int8 moment as its codes plus
``m.<param>@scales``) and a ``json`` metadata blob with the counters and
the sampler state. Noise and schedules are pure functions of (seed, step),
so nothing else is needed to resume.

Moments are stored in the JAX package's layout (conv HWIO, linear (in,
out)): a float moment is viewed in it on the way out and back on the way
in (the optimizer state's ``Layout``); int8 codes are held in it already.
The file holds no master weight (those go in the model file), so bf16 and
fp32 masters save and resume alike; a run whose memory plan downgraded its
moments to int8 blockwise saves codes and scales, and resumes from them
under the same plan (``opt.adamw.restored_state`` checks each moment's
storage against the optimizer's).

Under FSDP (``parallel/sharding.FSDP``) the state is sharded: every rank
gathers each sharded moment when its turn comes and global rank 0 writes
the same file as one process; on resume every rank reads the file and
keeps its shards (``FSDP.shard_state``), so a state resumes on any number
of ranks. Under pipeline parallelism the moments of a stage-stacked block
leaf are keyed ``__stack__.<suffix>`` and shaped ``[num_blocks, ...]`` in
the JAX layout, as the JAX package's pipeline run saves them: every stage
gathers its slices to the whole leaf when its turn comes (int8 codes over
the whole leaf's blocks, as the JAX package blocks them). Under tensor
parallelism every tp rank gathers the slices of each split tensor's
moments into the JAX layout when its turn comes (an int8 moment's codes;
its scales, the whole tensor's blocks', each tp rank holds already), and a
resume cuts the whole file into tp slices, so a state resumes on any dp x
tp and on one process.

Filenames mirror the reference:
``{stem}_step_{N}.safetensors`` + ``{stem}_training_state_step_{N}.safetensors``.
"""

from __future__ import annotations

import json
import re
import secrets
import string
import struct
from pathlib import Path

import ml_dtypes
import numpy as np
import torch
import torch.distributed as dist

from ..opt.adamw import INT8_BLOCK, SAME_LAYOUT, AdamWState, Layout
from .safetensors_io import read_metadata, write_streaming

_TORCH_OF_ST = {"F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16,
                "I8": torch.int8, "I32": torch.int32}
_NUMPY_OF_TORCH = {torch.float32: np.dtype(np.float32),
                   torch.bfloat16: np.dtype(ml_dtypes.bfloat16),
                   torch.float16: np.dtype(np.float16), torch.int8: np.dtype(np.int8)}


def output_model_stem(config, source_path) -> str:
    """Resolve OUTPUT_NAME with {uuid} substitution and sanitization; cached
    per run."""
    cached = getattr(config, "_RESOLVED_OUTPUT_STEM", None)
    if cached:
        return cached
    requested = str(getattr(config, "OUTPUT_NAME", "auto") or "auto").strip()
    if requested.lower() == "auto":
        requested = f"{Path(source_path).stem}_trained_{{uuid}}"
    run_uuid = "".join(secrets.choice(string.ascii_lowercase + string.digits)
                       for _ in range(6))
    requested = requested.replace("{uuid}", run_uuid)
    requested = Path(requested).name
    if requested.lower().endswith(".safetensors"):
        requested = requested[: -len(".safetensors")]
    requested = re.sub(r'[<>:"/\\|?*\x00-\x1f]', "_", requested).strip(" .")
    resolved = requested or f"{Path(source_path).stem}_trained_{run_uuid}"
    config._RESOLVED_OUTPUT_STEM = resolved
    return resolved


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` in its own dtype (bf16 via ml_dtypes)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def save_train_state(path, *, global_step: int, micro_step: int,
                     opt_state: AdamWState, sampler_seed: int,
                     sampler_epoch: int, timestep_sampler_state: dict | None,
                     extra: dict | None = None, fsdp=None) -> None:
    """Streams the moments to ``path`` one tensor at a time (each copied to
    the host when its turn comes), in the JAX package's layout. Host
    moments (the ``moments_host`` rung) are written from their pinned
    tensors, once the last step's copies into them are done.

    ``fsdp`` (``parallel.sharding.FSDP``): the moments of its sharded
    tensors are this rank's shards; each is gathered whole when its turn
    comes, so every rank of the world calls this, and global rank 0
    alone writes the file (the same file as from one process)."""
    if opt_state.host is not None:
        opt_state.host.synchronize()
    to_jax = opt_state.layout.to_jax
    specs = fsdp.specs if fsdp is not None else {}
    stages = fsdp.stages if fsdp is not None else {}
    tps = fsdp.tps if fsdp is not None else {}
    tensors = {"opt.step": np.asarray(opt_state.step, np.int32)}

    def lazy(t):
        return (tuple(t.shape), _NUMPY_OF_TORCH[t.dtype], lambda: _host_array(t))

    def gathered(name, value):
        spec = specs[name]
        return (spec.jax_shape, _NUMPY_OF_TORCH[value.dtype],
                lambda: _host_array(fsdp.gather_flat(name, value).view(spec.jax_shape)))

    def gathered_int8(name, codes, scales):
        spec, whole = specs[name], {}

        def codes_whole():
            c, whole["scales"] = fsdp.gather_int8(name, codes, scales)
            return _host_array(c)
        return ((spec.jax_shape, np.dtype(np.int8), codes_whole),
                ((-(-spec.numel // INT8_BLOCK),), np.dtype(np.float32),
                 lambda: _host_array(whole.pop("scales"))))

    def staged(name, value):
        spec = stages[name]
        return (spec.jax_shape, _NUMPY_OF_TORCH[value.dtype],
                lambda: _host_array(fsdp.gather_stages(name, to_jax(name, value))))

    def staged_int8(name, codes, scales):
        spec, whole = stages[name], {}

        def codes_whole():
            c, whole["scales"] = fsdp.gather_stages_int8(name, codes, scales)
            return _host_array(c)
        return ((spec.jax_shape, np.dtype(np.int8), codes_whole),
                ((-(-spec.numel // INT8_BLOCK),), np.dtype(np.float32),
                 lambda: _host_array(whole.pop("scales"))))

    def split(name, value):
        return (tps[name].jax_shape, _NUMPY_OF_TORCH[value.dtype],
                lambda: _host_array(to_jax(name, fsdp.gather_tp(name, value))))

    def split_int8(name, codes, scales):
        return ((tps[name].jax_shape, np.dtype(np.int8),
                 lambda: _host_array(fsdp.gather_tp(name, codes, jax=True))), lazy(scales))

    def put(prefix, name, value):
        if isinstance(value, tuple):  # int8_blockwise (codes, scales)
            tensors[f"{prefix}.{name}"], tensors[f"{prefix}.{name}@scales"] = (
                gathered_int8(name, *value) if name in specs
                else staged_int8(name, *value) if name in stages
                else split_int8(name, *value) if name in tps
                else (lazy(value[0]), lazy(value[1])))
        elif name in tps:
            tensors[f"{prefix}.{name}"] = split(name, value)
        elif name in stages:
            tensors[f"{prefix}.{name}"] = staged(name, value)
        elif name in specs:
            tensors[f"{prefix}.{name}"] = gathered(name, value)
        else:
            tensors[f"{prefix}.{name}"] = lazy(to_jax(name, value))

    for name, m in opt_state.exp_avg.items():
        put("m", name, m)
    for name, v in opt_state.exp_avg_sq.items():
        put("v", name, v)
    meta = {
        "global_step": global_step,
        "micro_step": micro_step,
        "sampler_seed": sampler_seed,
        "sampler_epoch": sampler_epoch,
        "timestep_sampler_state": timestep_sampler_state,
        **(extra or {}),
    }
    if fsdp is not None and dist.get_rank() != 0:
        # the same gathers, in the file's order, without the file
        for value in tensors.values():
            if isinstance(value, tuple):
                value[2]()
        return
    write_streaming(Path(path), tensors, metadata={"json": json.dumps(meta)})


def check_resume_global_batch(resume_meta: dict, global_batch: int) -> None:
    """Refuse resuming onto a layout that changes the schedule's global batch.

    The image/timestep schedules are pure functions of
    ``global_batch = BATCH_SIZE x dp`` (data/schedule.py); resuming a
    state trained at one global batch on a layout that implies another
    would silently reinterpret the entire remaining schedule. The basis is
    persisted in the train state, and a mismatch fails loudly.
    """
    saved = resume_meta.get("schedule_global_batch")
    if saved is None:
        print("WARNING: resume state predates the schedule-global-batch "
              "guard; cannot verify the batch schedule basis matches. "
              "Proceeding — ensure BATCH_SIZE x dp is unchanged from the "
              "original run.")
        return
    if int(saved) != int(global_batch):
        raise RuntimeError(
            f"Resume refused: this training state was saved with a global "
            f"batch of {int(saved)} (BATCH_SIZE x dp of the original run), "
            f"but the current mesh/config implies {int(global_batch)}. "
            f"Resuming would reinterpret the image/timestep schedules and "
            f"break bit-exact resume. Adjust BATCH_SIZE or the device "
            f"count/AOZORA_DEVICES so BATCH_SIZE x dp = {int(saved)}, or "
            f"start a fresh run.")


def _read_tensors(path) -> dict:
    """Every tensor of a safetensors file as a writable host tensor, each
    read into a buffer of its own (the file packs tensors without
    alignment)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        for name, spec in sorted(header.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            start, end = spec["data_offsets"]
            dtype = _TORCH_OF_ST[spec["dtype"]]
            t = torch.empty(spec["shape"], dtype=dtype)
            f.seek(8 + n + start)
            if end > start and f.readinto(t.view(-1).view(torch.uint8).numpy()) != end - start:
                raise IOError(f"{path}: {name} is cut short")
            out[name] = t
    return out


def load_train_state(path, layout: Layout = SAME_LAYOUT) -> tuple[dict, AdamWState]:
    """Returns (meta dict, AdamWState of HOST tensors keyed like params):
    float moments as views in the port's layout (``layout.from_jax``),
    int8 moments as (codes, scales) in the JAX package's.

    The tensors stay on the host: the trainer moves them to the device
    (``adamw.restored_state``) only once it has decided between restore and
    a fresh start, so a zero state never sits beside a restored one (the
    double residency of moments that ran a full-size resume out of
    memory)."""
    meta = json.loads(read_metadata(path).get("json", "{}"))
    tensors = _read_tensors(path)

    def collect(prefix):
        out = {}
        for k, t in tensors.items():
            if not k.startswith(prefix) or k.endswith("@scales"):
                continue
            name = k[len(prefix):]
            scales = tensors.get(f"{prefix}{name}@scales")
            out[name] = (t, scales) if scales is not None else layout.from_jax(name, t)
        return out

    step = int(tensors["opt.step"]) if "opt.step" in tensors else 0
    return meta, AdamWState(step=step, exp_avg=collect("m."),
                            exp_avg_sq=collect("v."), layout=layout)
