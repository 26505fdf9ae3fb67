"""Profiler trace behind a flag: ``AOZORA_PROFILE_DIR=/path``.

Counterpart of the JAX trainers' ``jax.profiler`` hook: micro steps 3..8
(and the apply steps among them) are traced with ``torch.profiler``, CPU
and CUDA activity. Into ``<dir>/<trainer>/`` it writes:

* ``trace.json.gz``: the Chrome trace, gzipped (chrome://tracing, Perfetto);
* ``kernels.txt``: ``key_averages()`` sorted by device time;
* ``summary.json``: the window's host wall time (synchronised at both
  ends), the device time summed over kernels, their ratio (the device's
  busy share; kernels on one stream do not overlap) and the top kernels
  by device time.

Tracing slows the host, so the steps it covers are not timing runs.

``AOZORA_STEP_LOG=/path/steps.jsonl`` appends one JSON line after every
micro step (the device synchronised first): the micro step, the host
clock (``time.perf_counter``), ``torch.cuda.max_memory_allocated`` and the
flash kernels' launch counts so far. It reads a run launched in a process
of its own, as the GUI launches the trainers; the sync costs each step
its host lead, so the step log's runs time each step whole.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import torch

WINDOW = (3, 8)   # first and last micro step traced, as the JAX package


class StepProfiler:
    def __init__(self, directory: str | os.PathLike | None,
                 step_log: str | os.PathLike | None = None):
        self.dir = Path(directory) if directory else None
        self.step_log = Path(step_log) if step_log else None
        self._prof = None
        self._t0 = 0.0

    @classmethod
    def from_env(cls, trainer: str, trace: bool = True) -> "StepProfiler":
        """``trace`` False: the step log only (the ranks of a torchrun world
        but global rank 0, each with its own ``AOZORA_STEP_LOG``)."""
        root = os.environ.get("AOZORA_PROFILE_DIR") if trace else None
        return cls(Path(root) / trainer if root else None,
                   os.environ.get("AOZORA_STEP_LOG") or None)

    def _sync(self) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def before_step(self, micro_step: int) -> None:
        if self.dir is None or micro_step != WINDOW[0]:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()
        self._t0 = time.perf_counter()

    def _log_step(self, micro_step: int) -> None:
        from ..ops import flash_attention
        self._sync()
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        entry = {"micro_step": micro_step, "t": time.perf_counter(),
                 "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else 0,
                 "flash_launches": {k: v for k, v in flash_attention.LAUNCHES.items() if v}}
        with open(self.step_log, "a", encoding="utf-8") as f:
            f.write(json.dumps(entry) + "\n")

    def after_step(self, micro_step: int) -> str | None:
        """Appends the step log's line; ends the trace after the window's
        last step and returns the message to log then, else None."""
        if self.step_log is not None:
            self._log_step(micro_step)
        if self._prof is None or micro_step != WINDOW[1]:
            return None
        self._sync()
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.dir / "trace.json.gz"))
        events = self._prof.key_averages()
        (self.dir / "kernels.txt").write_text(
            events.table(sort_by="self_device_time_total", row_limit=80))
        # the kernels' own rows (the ops that launch them repeat their time)
        device = sorted(((e.key, e.count, e.self_device_time_total / 1e6)
                         for e in events
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda r: -r[2])
        busy = sum(r[2] for r in device)
        (self.dir / "summary.json").write_text(json.dumps({
            "micro_steps": list(WINDOW), "wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall if wall > 0 else 0.0,
            "top_kernels_by_device_s": [
                {"name": n, "count": c, "device_s": s} for n, c, s in device[:60]],
        }, indent=1))
        self._prof = None
        return f"INFO: profiler trace written to {self.dir}"
