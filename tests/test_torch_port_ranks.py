"""Runs the PyTorch port on the ranks of a gloo world, for the CPU tests.

``launch`` starts each rank as a fresh interpreter (never a fork of a
process that has JAX loaded) with ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``AOZORA_PLATFORM=cpu`` and a ``file://`` store under the test's own
directory (no fixed port, so pytest-xdist workers can run side by side),
and kills every rank if one of them does not finish within the timeout.

Run as a module, a rank runs one task of the tests:

    python -m tests.test_torch_port_ranks ring inputs.npz out_prefix
    python -m tests.test_torch_port_ranks dit  inputs.npz out_prefix
    python -m tests.test_torch_port_ranks mesh inputs.npz out_prefix
    python -m tests.test_torch_port_ranks fsdp inputs.npz out_prefix
    python -m tests.test_torch_port_ranks pipeline inputs.npz out_prefix
    python -m tests.test_torch_port_ranks hop inputs.npz out_prefix
    python -m tests.test_torch_port_ranks tp inputs.npz out_prefix

and writes ``<out_prefix>_<rank>.npz``. Or it runs the port's SDXL CLI on
a preset (the CLI starts the process group), with the trainer's noise
taken from a table and the optimizer state it restores on resume written
back out through ``save_train_state`` (every rank joins the gathers):

    python -m tests.test_torch_port_ranks sdxl_cli noise.npy preset.json restored.safetensors

or the port's Anima CLI with FSDP's threshold lowered to ``min_elements``
(TINY models have no tensor of the JAX package's 2^16 elements), computing
in fp32 where the comma list ``flags`` holds ``fp32``, taking the cache
as current (a synthetic one without sources) where it holds ``nocache``,
and its noise table[micro_step] from ``noise.npy`` where one is given:

    python -m tests.test_torch_port_ranks anima_cli min_elements preset.json [flags [noise.npy]]

This module imports no JAX; its own tests check the launcher.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def launch(commands, work_dir: Path, *, timeout: float = 240.0, env=None):
    """Starts ``commands`` (one argv list per process) side by side and
    returns [(returncode, stdout, stderr)] in order. Process i gets
    ``env[i]`` on top of the base environment. If they have not all ended
    within ``timeout`` seconds, every one still running is killed and
    ``subprocess.TimeoutExpired`` is raised."""
    return finish(start(commands, work_dir, env=env), timeout=timeout)


def start(commands, work_dir: Path, *, env=None) -> list:
    """``launch``'s first half: the processes, started (the caller may work
    meanwhile); ``finish`` waits for them."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("XLA_", "JAX_", "WORLD_SIZE", "RANK",
                                 "LOCAL_RANK", "AOZORA_DIST_INIT"))}
    base.update({"AOZORA_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
                 "PYTHONPATH": str(REPO), "GLOO_SOCKET_IFNAME": "lo"})
    return [subprocess.Popen(cmd, cwd=work_dir, env={**base, **(env[i] if env else {})},
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i, cmd in enumerate(commands)]


def finish(procs: list, *, timeout: float = 240.0):
    """``launch``'s second half: [(returncode, stdout, stderr)] of the
    started processes, all killed if they have not ended in ``timeout``
    seconds (``subprocess.TimeoutExpired``)."""
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def world_env(n: int, store: Path) -> list[dict]:
    """The environment of each of ``n`` ranks meeting at ``store``."""
    return [{"WORLD_SIZE": str(n), "RANK": str(r), "LOCAL_RANK": str(r),
             "AOZORA_DIST_INIT": f"file://{store}"} for r in range(n)]


def run_world(cmd, n: int, work_dir: Path, name: str, *, timeout: float = 240.0,
              extra_env=None):
    """Runs ``cmd`` on each of ``n`` gloo ranks; asserts that every rank
    exits 0 and returns their (stdout, stderr)."""
    env = [{**e, **(extra_env or {})} for e in world_env(n, work_dir / f"{name}_store")]
    results = launch([cmd] * n, work_dir, timeout=timeout, env=env)
    for rank, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{out}\n{err}"
    return [(out, err) for _, out, err in results]


def run_task(task: str, n: int, inputs: Path, work_dir: Path,
             timeout: float = 240.0) -> list[dict]:
    """Runs ``task`` on ``n`` gloo ranks; returns each rank's arrays."""
    prefix = work_dir / task
    cmd = [sys.executable, "-m", "tests.test_torch_port_ranks", task, str(inputs),
           str(prefix)]
    run_world(cmd, n, work_dir, task, timeout=timeout)
    return [dict(np.load(f"{prefix}_{r}.npz")) for r in range(n)]


# --------------------------------------------------------------------------
# tasks (run inside each rank)
# --------------------------------------------------------------------------

def _ring(inputs, group, n):
    """sp_ring_attention on the global q, k, v; out and the whole q/k/v
    gradients for the upstream gradient ``g``."""
    import torch
    from aozora_sdxl_training_tpu_torch.ops.ring_attention import (
        SPRingConfig, sp_ring_attention)
    q, k, v = (torch.from_numpy(inputs[x]).requires_grad_(True) for x in "qkv")
    out = sp_ring_attention(q, k, v, SPRingConfig(group, n, "xla"))
    out.backward(torch.from_numpy(inputs["g"]))
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _dit(inputs, group, n):
    """A TINY DiT forward under SP (Full remat unless ``inputs["remat"]``
    names another mode; under Full each block's recompute runs the ring
    again) and the gradients of sum(out * tangent), with the number of
    calls of the flash forward's CPU implementation."""
    import torch
    from dataclasses import replace
    from aozora_sdxl_training_tpu_torch.models.anima import dit
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    from aozora_sdxl_training_tpu_torch.ops.ring_attention import SPRingConfig
    cfg = replace(dit.TINY_ANIMA, **{k[4:]: int(inputs[k]) for k in inputs
                                     if k.startswith("cfg.")})
    params = dit.params_from_jax({k[2:]: inputs[k] for k in inputs
                                  if k.startswith("p.")})
    for p in params.values():
        p.requires_grad_(True)
    calls = []
    plain = fa.flash_forward_reference
    fa.flash_forward_reference = lambda *a: calls.append(1) or plain(*a)
    out = dit.dit_forward(
        params, *(torch.from_numpy(inputs[x]) for x in ("latents", "t", "ctx")),
        cfg=cfg, t5_ids=torch.from_numpy(inputs["ids"]),
        attn_impl=SPRingConfig(group, n, "xla"), compute_dtype=torch.float32,
        remat=str(inputs["remat"]) if "remat" in inputs else "full")
    (out * torch.from_numpy(inputs["tangent"])).sum().backward()
    return {"out": out.detach().numpy(), "flash_fwd_calls": len(calls),
            **{f"g.{k}": p.grad.numpy() for k, p in params.items()}}


def _mesh(inputs, group, n):
    """make_mesh's dp and sp (or, given ``tp``, tp) groups: this rank's
    indices and the sums of the global ranks in each of its two groups."""
    import torch
    import torch.distributed as dist
    from aozora_sdxl_training_tpu_torch.parallel import sharding
    axis = "tp" if "tp" in inputs else "sp"
    mesh = sharding.make_mesh(dp=int(inputs["dp"]), **{axis: int(inputs[axis])})
    sums = [torch.tensor([dist.get_rank()]) for _ in range(2)]
    dist.all_reduce(sums[0], group=mesh.dp_group)
    dist.all_reduce(sums[1], group=getattr(mesh, f"{axis}_group"))
    return {"dp_rank": mesh.dp_rank, f"{axis}_rank": getattr(mesh, f"{axis}_rank"),
            "dp_sum": sums[0].item(), f"{axis}_sum": sums[1].item()}


def _fsdp(inputs, group, n):
    """FSDP over the ``dp`` x ``sp`` mesh (fp32 compute copies, the SDXL
    layout, every tensor of ``min`` elements or more with a dp-divisible
    axis sharded) on the tensors ``full.<name>``, on ``device`` (the CPU by
    default; "cuda": gloo on CUDA tensors): each sharded tensor gathered
    from its shards; then each rank's gradient ``grad.<name>[rank]`` put on
    the compute copies, reduce-scattered and synced as a step does, the
    result gathered whole, and the global norm."""
    import torch
    from aozora_sdxl_training_tpu_torch.models.sdxl.conversion import (
        from_jax_layout, to_jax_layout)
    from aozora_sdxl_training_tpu_torch.opt.adamw import Layout
    from aozora_sdxl_training_tpu_torch.parallel import sharding
    import torch.distributed as dist
    rank = dist.get_rank()
    device = torch.device(str(inputs["device"]) if "device" in inputs else "cpu")
    mesh = sharding.make_mesh(dp=int(inputs["dp"]), sp=int(inputs["sp"]))
    full = {k[5:]: torch.from_numpy(inputs[k]).to(device)
            for k in inputs if k.startswith("full.")}
    fsdp = sharding.FSDP(mesh, {k: tuple(v.shape) for k, v in full.items()},
                         Layout(to_jax_layout, from_jax_layout), torch.float32,
                         min_elements=int(inputs["min"]), bucket_bytes=int(inputs["bucket"]))
    params = {k: v.clone().requires_grad_(True) for k, v in full.items()}
    fsdp.shard_params(params)
    out = {f"gathered.{k}": fsdp.gather(k, p.detach()).cpu().numpy()
           for k, p in params.items() if k in fsdp.specs}
    out["backend"] = fsdp.backend
    out["sharded"] = np.array(sorted(fsdp.specs))
    out["held"] = np.array([p.numel() for k, p in params.items() if k in fsdp.specs])
    copies = fsdp.compute_copies(params)
    for k, c in copies.items():
        c.grad = torch.from_numpy(inputs[f"grad.{k}"][rank]).to(device)
    fsdp.reduce_scatter(copies, params)
    fsdp.sync(params)
    for k, p in params.items():
        out[f"reduced.{k}"] = (fsdp.gather(k, p.grad) if k in fsdp.specs
                               else p.grad).cpu().numpy()
        out[f"device.{k}"] = str(p.grad.device)
    out["norm"] = float(fsdp.grad_norm({k: p.grad for k, p in params.items()}))
    return out


def _hop(inputs, group, n):
    """``parallel.p2p.exchange`` around the world's ring on ``device``: each
    rank sends its row of ``x``, in fp32 and in bf16, to rank + 1 and
    receives from rank - 1; the received bits, their device and whether
    the hop was staged through host memory."""
    import torch
    import torch.distributed as dist
    from aozora_sdxl_training_tpu_torch.parallel import p2p
    rank, device = dist.get_rank(), torch.device(str(inputs["device"]))
    out = {"staged": p2p.staged(group, device)}
    for name, dtype, bits in (("float32", torch.float32, torch.int32),
                              ("bfloat16", torch.bfloat16, torch.int16)):
        sent = torch.from_numpy(inputs["x"][rank]).to(device=device, dtype=dtype)
        (got,) = p2p.exchange([(sent, (rank + 1) % n)], [(sent, (rank - 1) % n)], group)
        out[f"{name}.bits"] = got.view(bits).cpu().numpy()
        out[f"{name}.device"] = str(got.device)
    return out


def _tp(inputs, group, n):
    """The four functions of a tp region (``parallel/tensor_parallel.py``)
    over the world as one tp group, on ``device``, in fp32 and bf16: each
    rank's ``x[rank]`` through "reduce", "copy", "gather" and "scatter",
    and the gradients of sum(out * ``g[rank]``) for each; the outputs and
    gradients, and the bytes each function put into its collective."""
    import torch
    import torch.distributed as dist
    from aozora_sdxl_training_tpu_torch.parallel.tensor_parallel import TPConfig
    rank, device = dist.get_rank(), torch.device(str(inputs["device"]))
    tp = TPConfig(group, n, rank)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for kind in ("reduce", "copy", "gather", "scatter"):
            x = torch.from_numpy(inputs["x"][rank]).to(device, dtype).requires_grad_(True)
            y = getattr(tp, kind)(x)
            g = torch.from_numpy(inputs[f"g_{kind}"][rank]).to(device, dtype)
            (y * g).sum().backward()
            out[f"{tag}.{kind}.out"] = y.detach().float().cpu().numpy()
            out[f"{tag}.{kind}.grad"] = x.grad.float().cpu().numpy()
            out[f"{tag}.{kind}.device"] = str(y.device)
    out.update({f"bytes.{k}": v for k, v in tp.stats.items()})
    return out


def _pipeline(inputs, group, n):
    """For each case ``c`` of ``inputs["cases"]``: pp_dit_forward of a TINY
    DiT (``c.cfg.*`` overrides, the JAX package's params ``p.*``) over a dp x
    pp mesh (``dp``, ``pp``; fp32; ``c.remat``), with FSDP (threshold
    ``min``) on the tensors around the stack, each dp rank taking its rows
    of ``c.latents``/``c.t``/``c.ctx``/``c.ids`` in ``c.micro``
    microbatches; the output rows, and the whole gradients of sum(out *
    ``c.tangent``) over the dp ranks (flat names, the port's layout)
    after the step's reduce-scatter and sync, their global norm, and the
    stage's hops and elements. Then one int8 AdamW step
    (``min8``) on this rank's tensors with those gradients, written by
    ``save_train_state`` to ``c.state`` (rank 0)."""
    import torch
    import torch.distributed as dist
    from dataclasses import replace
    from aozora_sdxl_training_tpu_torch.ckpt.train_state import save_train_state
    from aozora_sdxl_training_tpu_torch.models.anima import dit
    from aozora_sdxl_training_tpu_torch.opt import adamw
    from aozora_sdxl_training_tpu_torch.parallel import p2p, pipeline as pl, sharding
    mesh = sharding.make_mesh(dp=int(inputs["dp"]), pp=int(inputs["pp"]))
    out = {"dp_rank": mesh.dp_rank, "pp_rank": mesh.pp_rank}
    for c in [str(x) for x in inputs["cases"]]:
        get = {k[len(c) + 1:]: v for k, v in inputs.items() if k.startswith(c + ".")}
        cfg = replace(dit.TINY_ANIMA, **{k[4:]: int(v) for k, v in get.items()
                                         if k.startswith("cfg.")})
        params = pl.stackify_params(
            dit.params_from_jax({k[2:]: inputs[k] for k in inputs if k.startswith("p.")}),
            cfg.num_blocks)
        fsdp = sharding.FSDP(mesh, {k: tuple(v.shape) for k, v in params.items()},
                             adamw.Layout(dit.to_jax_layout, dit.from_jax_layout),
                             torch.float32, min_elements=int(inputs["min"]))
        for p in params.values():
            p.requires_grad_(True)
        fsdp.shard_params(params)
        b = get["latents"].shape[0] // mesh.dp
        rows = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
        copies = fsdp.compute_copies(params)
        stacked, rest = pl.split_stacked(copies)
        p2p.reset_stats()
        y = pl.pp_dit_forward(
            stacked, rest, *(torch.from_numpy(get[x][rows]) for x in ("latents", "t", "ctx")),
            cfg=cfg, mesh=mesh, microbatches=int(get["micro"]),
            t5_ids=torch.from_numpy(get["ids"][rows]), attn_impl="xla",
            compute_dtype=torch.float32, remat=str(get["remat"]))
        (y * torch.from_numpy(get["tangent"][rows])).sum().backward()
        fsdp.reduce_scatter(copies, params)
        fsdp.sync(params)
        grads = {k: (fsdp.gather(k, p.grad) if k in fsdp.specs else
                     fsdp.gather_stages(k, p.grad) if k in fsdp.stages else p.grad)
                 for k, p in params.items()}
        out.update({f"{c}.out": y.detach().numpy(),
                    f"{c}.norm": float(fsdp.grad_norm({k: p.grad for k, p in params.items()})),
                    f"{c}.hops": p2p.STATS["pipeline"]["hops"],
                    f"{c}.hop_bytes": p2p.STATS["pipeline"]["bytes_sent"],
                    f"{c}.stage_elements": sum(p.numel() for k, p in params.items()
                                               if k in fsdp.stages)})
        out.update({f"{c}.g.{k}": v.numpy()
                    for k, v in pl.unstackify_params(grads, cfg.num_blocks).items()})
        opt_cfg = adamw.AdamWConfig(momentum_dtype="int8_blockwise",
                                    min_8bit_size=int(inputs["min8"]))
        state = adamw.init_state(params, opt_cfg, fsdp.opt_layout())
        with torch.no_grad():
            adamw.apply_updates(params, {k: p.grad for k, p in params.items()}, state,
                                opt_cfg, lr=1e-3)
        save_train_state(str(get["state"]), global_step=1, micro_step=1, opt_state=state,
                         sampler_seed=0, sampler_epoch=0, timestep_sampler_state=None,
                         fsdp=fsdp)
    dist.barrier()
    return out


def sdxl_cli(noise: str, preset: str, restored: str) -> int:
    """The port's SDXL CLI on ``preset`` (one process, or a rank of the
    world in this process's environment) over a synthetic cache (no source
    images: the cache check is skipped), computing in fp32 (the presets'
    ``MIXED_PRECISION`` has no fp32 value), its noise table[micro_step]
    from ``noise``; a restored optimizer state is written to ``restored``
    as the trainer holds it (gathered under FSDP)."""
    import torch
    from aozora_sdxl_training_tpu_torch.ckpt import train_state
    from aozora_sdxl_training_tpu_torch.cli import train_sdxl
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.opt import adamw
    from aozora_sdxl_training_tpu_torch.parallel import sharding
    from aozora_sdxl_training_tpu_torch.train import objectives, trainer
    table = np.load(noise)
    objectives.noise_for_step = (
        lambda seed, ms, shape, device: torch.from_numpy(table[ms]).to(device))
    trainer.check_if_caching_needed = lambda config: False
    parse = RuntimeConfig.from_argv

    def fp32(argv):
        config = parse(argv)
        config.compute_dtype = torch.float32
        return config

    RuntimeConfig.from_argv = staticmethod(fp32)
    made, init, restore = [], sharding.FSDP.__init__, adamw.restored_state

    def kept(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def restored_state(*a, **kw):
        state = restore(*a, **kw)
        train_state.save_train_state(
            restored, global_step=0, micro_step=0, opt_state=state, sampler_seed=0,
            sampler_epoch=0, timestep_sampler_state=None,
            fsdp=made[-1] if made else None)
        return state

    sharding.FSDP.__init__ = kept
    adamw.restored_state = restored_state
    train_sdxl.main(["--config", preset])
    return 0


def anima_cli(min_elements: str, preset: str, flags: str = "", noise: str = "") -> int:
    from aozora_sdxl_training_tpu_torch.cli import train_anima
    from aozora_sdxl_training_tpu_torch.parallel import sharding
    sharding.MIN_SHARD_ELEMENTS = int(min_elements)
    if noise:
        import torch
        from aozora_sdxl_training_tpu_torch.train import objectives
        table = np.load(noise)
        objectives.noise_for_step = (
            lambda seed, ms, shape, device: torch.from_numpy(table[ms]).to(device))
    flags = flags.split(",")
    if "nocache" in flags:
        from aozora_sdxl_training_tpu_torch.train import anima_trainer
        anima_trainer.check_if_anima_caching_needed = lambda config: False
    if "fp32" in flags:
        import torch
        from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
        parse = RuntimeConfig.from_argv

        def in_fp32(argv):
            config = parse(argv)
            config.compute_dtype = torch.float32
            return config

        RuntimeConfig.from_argv = staticmethod(in_fp32)
    train_anima.main(["--config", preset])
    return 0


def main(argv) -> int:
    import torch.distributed as dist
    from aozora_sdxl_training_tpu_torch.parallel import sharding
    if argv[:1] == ["sdxl_cli"]:
        return sdxl_cli(*argv[1:])
    if argv[:1] == ["anima_cli"]:
        return anima_cli(*argv[1:])
    task, inputs, prefix = argv
    sharding.init_distributed()
    try:
        n, rank = dist.get_world_size(), dist.get_rank()
        result = {"ring": _ring, "dit": _dit, "mesh": _mesh, "fsdp": _fsdp,
                  "pipeline": _pipeline, "hop": _hop, "tp": _tp}[task](
            dict(np.load(inputs)), dist.group.WORLD, n)
        np.savez(f"{prefix}_{rank}.npz", **result)
    finally:
        sharding.destroy_distributed()
    return 0


# --------------------------------------------------------------------------
# the launcher's own tests
# --------------------------------------------------------------------------

def test_launch_kills_a_rank_that_hangs(tmp_path):
    """A hung rank fails its test within the timeout, and no process of
    the world outlives the call."""
    import pytest
    cmds = [[sys.executable, "-c", "import time; time.sleep(120)"],
            [sys.executable, "-c", "print('done')"]]
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        launch(cmds, tmp_path, timeout=3.0)
    assert time.monotonic() - t0 < 60


def test_each_rank_gets_its_world(tmp_path):
    """Ranks see their own RANK, the world size and the store, and the CPU
    platform; nothing of the caller's world or JAX flags leaks in."""
    code = ("import os; print(os.environ['RANK'], os.environ['WORLD_SIZE'], "
            "os.environ['AOZORA_PLATFORM'], "
            "os.environ['AOZORA_DIST_INIT'].startswith('file://'), "
            "any(k.startswith('XLA_') for k in os.environ))")
    outs = run_world([sys.executable, "-c", code], 3, tmp_path, "probe", timeout=60)
    assert [o.split() for o, _ in outs] == [[str(r), "3", "cpu", "True", "False"]
                                            for r in range(3)]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
