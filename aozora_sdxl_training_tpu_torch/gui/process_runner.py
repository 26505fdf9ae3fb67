"""Trainer subprocess management for the GUI shell.

Counterpart of ``aozora_sdxl_training_tpu/gui/process_runner.py``.
Display-independent port of the reference's ``ProcessRunner``
(the reference's gui/gui.py:2685-2758): launches a trainer as
``python -u <script> --config <preset>``, or a CLI module as ``python -u -m
<module> --config <preset>`` (the app's way), in its own process group, reads
stdout line-by-line on a worker thread, routes lines to callbacks (log /
progress / metrics), and kills the whole group on stop (SIGTERM then
SIGKILL).  Also writes the ``force_save.flag`` emergency-checkpoint file the
trainers consume (gui.py:5981-5991).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path


class ProcessRunner:
    def __init__(self, args: list[str], *, cwd=None, env=None,
                 on_line=None, on_progress=None, on_exit=None):
        self.args = args
        self.cwd = str(cwd) if cwd else None
        self.env = env
        self.on_line = on_line or (lambda line: None)
        self.on_progress = on_progress or (lambda line: None)
        self.on_exit = on_exit or (lambda code: None)
        self.process: subprocess.Popen | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        # binary pipe: text mode would fold the \r progress updates into \n
        kwargs: dict = dict(
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=self.cwd, env=self.env, bufsize=0)
        if os.name == "posix":
            kwargs["start_new_session"] = True  # own process group for kill
        self.process = subprocess.Popen(self.args, **kwargs)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        assert self.process and self.process.stdout
        buffer = bytearray()
        while True:
            ch = self.process.stdout.read(1)
            if ch == b"":
                break
            if ch in (b"\n", b"\r"):
                if buffer:
                    line = buffer.decode("utf-8", errors="replace")
                    # \r lines are in-place progress updates
                    (self.on_progress if ch == b"\r" else self.on_line)(line)
                buffer = bytearray()
            else:
                buffer += ch
        if buffer:
            self.on_line(buffer.decode("utf-8", errors="replace"))
        code = self.process.wait()
        self.on_exit(code)

    def is_running(self) -> bool:
        return self.process is not None and self.process.poll() is None

    def stop(self, grace_seconds: float = 5.0) -> None:
        """SIGTERM the process group; SIGKILL after the grace period."""
        if not self.is_running():
            return
        assert self.process is not None
        try:
            if os.name == "posix":
                os.killpg(os.getpgid(self.process.pid), signal.SIGTERM)
            else:
                self.process.terminate()
        except (ProcessLookupError, OSError):
            return
        deadline = time.time() + grace_seconds
        while time.time() < deadline:
            if self.process.poll() is not None:
                return
            time.sleep(0.1)
        try:
            if os.name == "posix":
                os.killpg(os.getpgid(self.process.pid), signal.SIGKILL)
            else:
                self.process.kill()
        except (ProcessLookupError, OSError):
            pass

    def wait(self, timeout=None) -> int | None:
        if self.process is None:
            return None
        return self.process.wait(timeout)


# the directory that holds this package: a launched ``-m`` module imports
# from it whatever the trainer's working directory
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def trainer_args(target, config_path, *, python=None, module=False) -> list[str]:
    """``python -u <script> --config <preset>``, or with ``module``
    ``python -u -m <module> --config <preset>``."""
    return [python or sys.executable, "-u", *(("-m",) if module else ()),
            str(target), "--config", str(config_path)]


def launch_trainer(script: str, config_path, *, python=None, cwd=None,
                   module=False, env=None, **runner_kwargs) -> ProcessRunner:
    """`python -u <script> --config <preset>` — the GUI's launch command
    (gui.py:5936-5964). With ``module``, ``script`` names a module run as
    ``python -u -m <module>``, importable from this package's root (put
    first on ``PYTHONPATH``)."""
    if module:
        env = dict(os.environ if env is None else env)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_PACKAGE_ROOT), env.get("PYTHONPATH", "")) if p)
    runner = ProcessRunner(
        trainer_args(script, config_path, python=python, module=module),
        cwd=cwd, env=env, **runner_kwargs)
    runner.start()
    return runner


def request_force_save(trainer_cwd) -> Path:
    """Drop force_save.flag where the trainer looks for it."""
    flag = Path(trainer_cwd) / "force_save.flag"
    flag.write_text("save")
    return flag
