"""PyTorch port: the Anima CLI on several gloo ranks, and the dp x sp layout.

* The port's Anima CLI (``AOZORA_PLATFORM=cpu``) trains a TINY DiT on a
  synthetic cache four ways, side by side, each in fresh interpreters
  without JAX (``tests/test_torch_port_ranks.py``):
  one process at ``BATCH_SIZE`` 1 and 2, two ranks with
  ``SEQUENCE_PARALLEL_SIZE`` 2 (ring attention, Full remat) and two ranks
  with SP 1 (dp=2, ``BATCH_SIZE`` 1 per dp shard, so a global batch of 2).
  A fifth run, two SP ranks with ``AOZORA_LOWMEM_RUNG=two_pass`` at GA 1,
  takes the fused step, as the JAX trainer does under a mesh.
  The SP run reproduces the one-process run at batch 1 and the dp run the
  one-process run at batch 2: per-step losses and the saved DiT. The dp
  run shards its state (FSDP, ``parallel/sharding.FSDP``; the threshold
  lowered to ``FSDP_MIN`` elements through ``tests/test_torch_port_ranks``'s
  ``anima_cli``, since TINY's tensors all lie below the JAX package's
  2^16), and each rank holds half of the sharded elements. Only
  global rank 0 prints the GUI lines and saves; the dp run saves at each
  optimizer step, the DiT and the training state (``schedule_global_batch``
  2), and a trainer whose global rank is not 0 writes no file at all.
  ``tests/test_torch_port_anima_trainer.py`` holds the one-process run
  against the JAX trainer.
* The port's ``resolve_mesh_layout`` against the JAX function under
  ``AOZORA_DEVICES`` n <= 8 (ranks of an 8-rank world in the port, the 8
  virtual CPU devices in JAX): the same layout and the same messages.
* ``make_mesh`` on 4 gloo ranks builds the dp and sp groups of the JAX
  mesh's row-major (dp, sp) layout.

Tolerances: the DiT computes in bf16 and the ring merges attention
partials where the one-process run takes one softmax, so the printed
losses agree to rtol 1e-2 (atol 2e-3 for their four decimals); the saved
DiTs are held as ``test_torch_port_anima_trainer.py`` holds the port's
against the JAX trainer's (Adam's worst-case step where bf16 noise flips
a tiny gradient's sign, the whole update's norm within 1% and its
direction within cosine 0.95).
"""

import json
import re
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from aozora_sdxl_training_tpu.parallel import sharding as jax_shard
from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all, read_header
from aozora_sdxl_training_tpu_torch.ckpt.train_state import load_train_state
from aozora_sdxl_training_tpu_torch.config import schema
from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
from aozora_sdxl_training_tpu_torch.data.synthetic import (
    write_random_dit_checkpoint, write_synthetic_anima_dataset)
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.parallel import sharding as port_shard

from tests.test_torch_port_ranks import launch, run_task, world_env
from tests.test_torch_port_trainer import one_thread

CFG = replace(port_dit.TINY_ANIMA, in_channels=4, out_channels=4, adapter_vocab=128)
STEPS, GA, LR = 4, 2, 1e-4
FLAT = {
    "TRAINING_MODE": "Anima DiT",
    "OUTPUT_NAME": "anima_run",
    "MAX_TRAIN_STEPS": STEPS,
    "GRADIENT_ACCUMULATION_STEPS": GA,
    "SAVE_EVERY_N_STEPS": 0,
    "SEED": 5,
    "MIXED_PRECISION": "bfloat16",
    "CLIP_GRAD_NORM": 1.0,
    "OPTIMIZER_TYPE": "raven",
    "LR_CUSTOM_CURVE": [[0.0, LR], [1.0, LR]],
    "SHOULD_UPSCALE": False,
    "ANIMA_GRADIENT_CHECKPOINTING_MODE": "Full",
}
ANIMA_PROGRESS = re.compile(
    r'Training\s*\|.*\|\s*(\d+)/(\d+)\s*\[.*?\]\s*\[Loss:\s*([\d.e+-]+),'
    r'\s*Ticket:\s*(\d+),\s*Sigma:\s*([\d.e+-]+)\]')
# name: (ranks, BATCH_SIZE, SEQUENCE_PARALLEL_SIZE)
RUNS = {"one_b1": (1, 1, 1), "one_b2": (1, 2, 1), "sp2": (2, 1, 2), "dp2": (2, 1, 1),
        "sp2_rung": (2, 1, 2)}
SAVING = "dp2"      # the run that saves at each optimizer step
RUNG = "sp2_rung"   # the run with AOZORA_LOWMEM_RUNG=two_pass at GA 1
SHARDED = "dp2"     # the run whose state FSDP shards
FSDP_MIN = 4096     # its FSDP threshold (elements)


def _flat(root: Path, name: str, batch: int, sp: int) -> dict:
    return {**FLAT, "DIT_PATH": str(root / "tiny_dit.safetensors"),
            "OUTPUT_DIR": str(root / name), "BATCH_SIZE": batch,
            "SEQUENCE_PARALLEL_SIZE": sp,
            "GRADIENT_ACCUMULATION_STEPS": 1 if name == RUNG else GA,
            "SAVE_EVERY_N_STEPS": 1 if name == SAVING else 0,
            # a 2-step preview after each optimizer step (latent-RGB: no VAE
            # file), which the sharded run gathers on both ranks for rank 0
            "ANIMA_PREVIEW_EVERY_N_STEPS": 1 if name == SHARDED else 0,
            "ANIMA_PREVIEW_SAMPLE_STEPS": 2,
            "INSTANCE_DATASETS": [{"path": str(root / "data"), "repeats": 1}]}


def _progress(stdout: str):
    segs = [s.strip() for chunk in stdout.split("\n") for s in chunk.split("\r")]
    return [m for m in map(ANIMA_PROGRESS.search, segs) if m]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes the checkpoint and a cache of four 64 x 64 images (the 640 x
    640 bucket: 1600 tokens), then runs the four trainings side by side.
    Returns (root, {name: [stdout of each rank]})."""
    root = tmp_path_factory.mktemp("port_anima_sp")
    write_random_dit_checkpoint(root / "tiny_dit.safetensors", CFG, seed=3)
    config = RuntimeConfig(_flat(root, "x", 1, 1), validate_resume_paths=False)
    # the cache options name the VAE source relative to the working
    # directory: write the cache from the one the CLI runs in
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        write_synthetic_anima_dataset(root / "data", config, n_images=4,
                                      image_size=(64, 64),
                                      source_dim=CFG.adapter_source_dim, vocab=100,
                                      latent_channels=CFG.in_channels, seed=6)
    commands, envs, owners = [], [], []
    for name, (ranks, batch, sp) in RUNS.items():
        preset = root / f"{name}.json"
        preset.write_text(json.dumps(schema.nest_flat_config(
            _flat(root, name, batch, sp), "anima")))
        cmd = ([sys.executable, "-m", "tests.test_torch_port_ranks", "anima_cli",
                str(FSDP_MIN), str(preset)] if name == SHARDED else
               [sys.executable, "-m", "aozora_sdxl_training_tpu_torch.cli.train_anima",
                "--config", str(preset)])
        rank_envs = world_env(ranks, root / f"{name}_store") if ranks > 1 else [{}]
        for env in rank_envs:
            if name == RUNG:
                env["AOZORA_LOWMEM_RUNG"] = "two_pass"
            commands.append(cmd)
            envs.append(env)
            owners.append(name)
    results = launch(commands, root, timeout=400, env=envs)
    out: dict = {name: [] for name in RUNS}
    for name, (code, stdout, stderr) in zip(owners, results):
        assert code == 0, f"{name} rank {len(out[name])} exited {code}:\n{stdout}\n{stderr}"
        out[name].append(stdout)
    return root, out


@pytest.mark.parametrize("name", list(RUNS))
def test_only_global_rank_0_prints_and_saves(runs, name):
    root, out = runs
    progress = _progress(out[name][0])
    assert sorted({int(m.group(1)) for m in progress}) == list(range(1, STEPS + 1))
    assert "All tasks complete" in out[name][0]
    for other in out[name][1:]:
        assert _progress(other) == [] and other.strip() == ""
    saved = ["anima_run.safetensors"]
    if name == SAVING:
        saved += [f"anima_run{kind}_step_{n}.safetensors"
                  for kind in ("", "_training_state") for n in (1, 2)]
        for n in (1, 2):
            meta, state = load_train_state(
                root / name / f"anima_run_training_state_step_{n}.safetensors")
            assert meta["global_step"] == state.step == n
            assert meta["micro_step"] == n * GA and meta["schedule_global_batch"] == 2
    assert sorted(p.name for p in (root / name).glob("*.safetensors")) == sorted(saved)
    if RUNS[name][2] > 1:
        assert "Sequence parallelism: DiT self-attention tokens shard over sp=2" in out[name][0]


def test_forced_rung_under_torchrun_takes_the_fused_step(runs):
    """``AOZORA_LOWMEM_RUNG=two_pass`` at GA 1 on two SP ranks: as in JAX,
    the planner (sp only: no dp sharding) plans the rung, and the ranks
    take the fused step with the moments on the device, saying so; the
    run ends with finite losses, and its first loss (bf16 masters: the
    checkpoint's weights rounded) is the one-process run's to 1e-2."""
    _, out = runs
    text = out[RUNG][0]
    assert "two-pass step (GA=1" in text and "moments: int8_blockwise" in text
    assert "INFO: the low-memory rung runs on one device only; the 2 ranks take the fused step" in text
    got, want = _losses(text), _losses(out["one_b1"][0])
    assert len(got) == STEPS and all(np.isfinite(got))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-2, atol=2e-3)
    assert [int(m) for m in re.findall(r"--- Optimizer Step: (\d+)", text)] == list(
        range(1, STEPS + 1))


def _losses(stdout):
    by_step = {int(m.group(1)): float(m.group(3)) for m in _progress(stdout)}
    return [by_step[s] for s in sorted(by_step)]


@pytest.mark.parametrize("name,reference", [("sp2", "one_b1"), ("dp2", "one_b2")])
def test_losses_match_the_one_process_run(runs, name, reference):
    _, out = runs
    got, want = _losses(out[name][0]), _losses(out[reference][0])
    assert len(got) == len(want) == STEPS and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("name,reference", [("sp2", "one_b1"), ("dp2", "one_b2")])
def test_saved_dit_matches_the_one_process_run(runs, name, reference):
    root, _ = runs
    got = load_all(root / name / "anima_run.safetensors")
    want = load_all(root / reference / "anima_run.safetensors")
    base = load_all(root / "tiny_dit.safetensors")
    assert got.keys() == want.keys() == base.keys()
    assert all(v["dtype"] == "BF16"
               for v in read_header(root / name / "anima_run.safetensors").values())
    upd_got, upd_want = [], []
    for key in want:
        a, b, w0 = (np.asarray(t[key], np.float32) for t in (got, want, base))
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7,
                                   atol=2 * (3.63 + 4.71) * LR * 1.01, err_msg=key)
        upd_got.append((a - w0).ravel())
        upd_want.append((b - w0).ravel())
    upd_got, upd_want = np.concatenate(upd_got), np.concatenate(upd_want)
    n_got, n_want = np.linalg.norm(upd_got), np.linalg.norm(upd_want)
    assert n_want > 0
    assert n_got == pytest.approx(n_want, rel=1e-2)
    assert upd_got @ upd_want / (n_got * n_want) >= 0.95


# --------------------------------------------------------------------------
# layout and groups
# --------------------------------------------------------------------------

class _Cfg:
    def __init__(self, batch, tp, sp, pp):
        self.BATCH_SIZE, self.TENSOR_PARALLEL_SIZE = batch, tp
        self.SEQUENCE_PARALLEL_SIZE, self.PIPELINE_PARALLEL_SIZE = sp, pp


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("batch,tp,sp,pp", [
    (1, 1, 1, 1), (2, 1, 2, 1), (1, 1, 4, 1), (3, 1, 3, 1), (1, 2, 1, 1),
    (2, 2, 2, 1), (1, 1, 1, 2), (1, 1, 2, 2), (1, 1, 8, 1)])
def test_resolve_mesh_layout_matches_jax(monkeypatch, capsys, n, batch, tp, sp, pp):
    """The port over an 8-rank torchrun world, JAX over the 8 virtual CPU
    devices, both capped at n by AOZORA_DEVICES: the same (dp, tp, sp,
    pp, global batch, mesh use), the same devices by index, and the same
    WARNING/INFO lines."""
    monkeypatch.setenv("AOZORA_DEVICES", str(n))
    want = jax_shard.resolve_mesh_layout(_Cfg(batch, tp, sp, pp))
    want_out = capsys.readouterr().out
    monkeypatch.setenv("WORLD_SIZE", "8")
    got = port_shard.resolve_mesh_layout(_Cfg(batch, tp, sp, pp))
    assert capsys.readouterr().out == want_out
    assert got[1:] == want[1:]
    assert list(got.devices) == [d.id for d in want.devices]


def test_layout_without_torchrun_is_one_device(monkeypatch):
    for key in ("WORLD_SIZE", "AOZORA_DEVICES"):
        monkeypatch.delenv(key, raising=False)
    layout = port_shard.resolve_mesh_layout(_Cfg(2, 1, 2, 1))
    assert (layout.devices, layout.dp, layout.sp, layout.global_batch,
            layout.use_mesh) == ((0,), 1, 1, 2, False)
    assert port_shard.init_distributed() is None


def test_make_mesh_groups_on_four_ranks(tmp_path):
    """dp=2 x sp=2: rank = dp_index * sp + sp_index. Each rank all-reduces
    its global rank within its dp group and within its sp group."""
    np.savez(tmp_path / "inputs.npz", dp=2, sp=2)
    ranks = run_task("mesh", 4, tmp_path / "inputs.npz", tmp_path, timeout=120)
    for r, got in enumerate(ranks):
        dp_rank, sp_rank = divmod(r, 2)
        assert (int(got["dp_rank"]), int(got["sp_rank"])) == (dp_rank, sp_rank)
        assert int(got["dp_sum"]) == sp_rank + (2 + sp_rank)      # ranks {s, 2+s}
        assert int(got["sp_sum"]) == 2 * dp_rank + (2 * dp_rank + 1)


def test_sdxl_trainer_refuses_more_than_one_process(monkeypatch, capsys):
    """On two processes the SDXL trainer's config lays out data
    parallelism (``tests/test_torch_port_sdxl_dp.py``), and with
    ``TENSOR_PARALLEL_SIZE`` 2 a dp 1 x tp 2 mesh, which nothing refuses any
    more (``tests/test_torch_port_tp_ranks.py`` trains on it)."""
    from aozora_sdxl_training_tpu_torch.train import trainer
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("AOZORA_DEVICES", raising=False)
    config = RuntimeConfig({**FLAT, "TRAINING_MODE": "SDXL"}, validate_resume_paths=False)
    assert port_shard.resolve_mesh_layout(config)[1:3] == (2, 1)
    config = RuntimeConfig({**FLAT, "TRAINING_MODE": "SDXL", "TENSOR_PARALLEL_SIZE": 2},
                           validate_resume_paths=False)
    layout = port_shard.resolve_mesh_layout(config)
    assert (layout.dp, layout.tp, layout.sp, layout.pp, layout.use_mesh) == (1, 2, 1, 1, True)
    assert "WARNING" not in capsys.readouterr().out
    assert not hasattr(trainer, "_refuse_unported")


def test_dp_run_shards_half_the_state_on_each_rank(runs):
    """The dp run's FSDP line (rank 0 prints every rank's count): the
    tensors of at least ``FSDP_MIN`` elements with an even axis are
    sharded, and each of the two ranks holds half of their elements (its
    shards padded to whole 256-element blocks); its previews, gathered on
    both ranks, are rank 0's PNGs."""
    root, out = runs
    text = out[SHARDED][0]
    assert "INFO: FSDP over dp=2 (gloo)" in text
    held = re.search(r"FSDP held per rank: sharded elements \[(\d+), (\d+)\] of ([\d,]+)", text)
    assert held, text
    a, b, total = int(held.group(1)), int(held.group(2)), int(held.group(3).replace(",", ""))
    assert a == b and total > 0
    assert 0.5 <= a / total < 0.5 + 256 * 60 / total
    assert "sharded over 2 device(s) (ZeRO)" in text
    previews = sorted(p.name for p in (root / SHARDED / "previews").iterdir())
    assert previews == [f"step_{n}_latent.png" for n in range(1, STEPS // GA + 1)]


def test_a_rank_other_than_0_writes_no_file(runs, monkeypatch):
    """The save guard itself: the trainer in one process, told its global
    rank is 1, trains and writes neither a DiT nor a training state."""
    from aozora_sdxl_training_tpu_torch.train import anima_trainer
    root, _ = runs
    monkeypatch.chdir(root)
    monkeypatch.setenv("AOZORA_PLATFORM", "cpu")
    monkeypatch.setattr(anima_trainer.shard, "global_rank", lambda: 1)
    config = RuntimeConfig({**_flat(root, "rank1", 1, 1), "SAVE_EVERY_N_STEPS": 1},
                           validate_resume_paths=False)
    with one_thread():
        anima_trainer.run_anima_training(config, device="cpu")
    assert list((root / "rank1").iterdir()) == []
