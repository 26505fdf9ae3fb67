"""Live-metrics parsing: trainer stdout -> chart series.

Copy of ``aozora_sdxl_training_tpu/gui/metrics.py``, kept in the port so that the
port imports nothing of the JAX package.

The display-independent core of the reference GUI's ``LiveMetricsWidget``
(the reference's gui/gui.py:1853-1932): the same regex grammar over trainer
stdout, EMA smoothing, and per-chart history series.  The Tk front-end
(gui/app.py) renders these; tests drive them headless.
"""

from __future__ import annotations

import re
from collections import deque
from dataclasses import dataclass, field

PROGRESS_TICKET_RE = re.compile(
    r'Training\s*\|.*\|\s*(\d+)/(\d+)\s*\[.*?\]\s*\[Loss:\s*([\d.e+-]+),'
    r'\s*Ticket:\s*(\d+),\s*Sigma:\s*([\d.e+-]+)\]')
PROGRESS_TIMESTEP_RE = re.compile(
    r'Training\s*\|.*\|\s*(\d+)/(\d+)\s*\[.*?\]\s*\[Loss:\s*([\d.e+-]+),'
    r'\s*Timestep:\s*(\d+)\]')
OPTIM_RE = re.compile(
    r'--- Optimizer Step:\s*(\d+)\s*\|\s*Loss:\s*([\d.e+-]+)\s*\|'
    r'\s*LR:\s*([\d.e+-]+)\s*---')
GRAD_RE = re.compile(r'Grad Norm \(Raw/Clipped\):\s*([\d.]+)\s*/\s*([\d.]+)')
# failure keywords the GUI flags (gui.py:2731-2732); word-bounded so that
# "info" and "infinite scroll" prose don't false-positive
FAILURE_RE = re.compile(r"cuda out of memory|access violation|\bnan\b|"
                        r"\binf\b|resource_exhausted", re.IGNORECASE)
# in-training preview sampling announcement (train/sampler.py, an
# extension) -> the GUI shows the latest preview image
PREVIEW_RE = re.compile(r"INFO: preview image saved -> (.+\.png)\s*$")


@dataclass
class Series:
    xs: deque = field(default_factory=lambda: deque(maxlen=20000))
    ys: deque = field(default_factory=lambda: deque(maxlen=20000))

    def append(self, x, y):
        self.xs.append(x)
        self.ys.append(y)

    def last(self):
        return (self.xs[-1], self.ys[-1]) if self.xs else None


class LiveMetrics:
    """Stateful stdout parser with the GUI's chart series + EMA smoothing."""

    def __init__(self, ema_beta: float = 0.98):
        self.ema_beta = ema_beta
        self.step_loss = Series()
        self.loss_ema = Series()
        self.optim_loss = Series()
        self.optim_loss_ema = Series()
        self.lr = Series()
        self.grad_raw = Series()
        self.grad_clipped = Series()
        self.timesteps: deque = deque(maxlen=20000)
        self.sigmas: deque = deque(maxlen=20000)
        # paired (ticket|sigma, loss) per progress line — feed the live
        # histogram + mean-loss-by-bin diagnostics (gui.py:1853-1943)
        self.ticket_loss: deque = deque(maxlen=20000)
        self.sigma_loss: deque = deque(maxlen=20000)
        self.failures: list[str] = []
        self.preview_paths: list[str] = []
        self._step_ema = None
        self._optim_ema = None
        self._last_optim_step = None
        self.total_steps = None

    def parse_line(self, text: str) -> bool:
        """Feed one stdout line; returns True if anything was extracted."""
        added = False
        m = PROGRESS_TICKET_RE.search(text) or PROGRESS_TIMESTEP_RE.search(text)
        if m:
            is_ticket = bool(PROGRESS_TICKET_RE.search(text))
            step = int(m.group(1)) - 1
            self.total_steps = int(m.group(2))
            loss = float(m.group(3))
            ticket = int(m.group(4))
            self.step_loss.append(step, loss)
            self._step_ema = (loss if self._step_ema is None else
                              self.ema_beta * self._step_ema
                              + (1 - self.ema_beta) * loss)
            self.loss_ema.append(step, self._step_ema)
            self.timesteps.append(ticket)
            self.ticket_loss.append((ticket, loss))
            if is_ticket:
                sigma = float(m.group(5))
                self.sigmas.append(sigma)
                self.sigma_loss.append((sigma, loss))
            added = True
        m = OPTIM_RE.search(text)
        if m:
            step, avg_loss, lr = int(m.group(1)), float(m.group(2)), float(m.group(3))
            self._last_optim_step = step
            self.optim_loss.append(step, avg_loss)
            self._optim_ema = (avg_loss if self._optim_ema is None else
                               self.ema_beta * self._optim_ema
                               + (1 - self.ema_beta) * avg_loss)
            self.optim_loss_ema.append(step, self._optim_ema)
            self.lr.append(step, lr)
            added = True
        m = GRAD_RE.search(text)
        if m and self._last_optim_step is not None:
            self.grad_raw.append(self._last_optim_step, float(m.group(1)))
            self.grad_clipped.append(self._last_optim_step, float(m.group(2)))
            added = True
        m = PREVIEW_RE.search(text)
        if m:
            self.preview_paths.append(m.group(1).strip())
            added = True
        if FAILURE_RE.search(text) and "Loss" not in text:
            self.failures.append(text.strip())
        return added

    @property
    def latest_preview(self) -> str | None:
        return self.preview_paths[-1] if self.preview_paths else None

    # --- live distribution diagnostics (gui.py:1853-1943) ---

    @staticmethod
    def _histogram(values, bins: int, lo: float, hi: float):
        """(edges[bins+1], counts[bins]) — pure python, no numpy needed in
        the render path."""
        bins = max(int(bins), 1)
        span = max(hi - lo, 1e-12)
        counts = [0] * bins
        for v in values:
            idx = int((float(v) - lo) / span * bins)
            counts[min(max(idx, 0), bins - 1)] += 1
        edges = [lo + span * i / bins for i in range(bins + 1)]
        return edges, counts

    def timestep_histogram(self, bins: int = 25, max_timestep: int = 1000):
        """Sampled-timestep distribution so curve edits show their effect
        live (reference timestep histogram, gui.py:1862-1890)."""
        return self._histogram(self.timesteps, bins, 0.0, float(max_timestep))

    def sigma_histogram(self, bins: int = 25):
        """RF-mode sigma distribution (reference sigma histogram)."""
        return self._histogram(self.sigmas, bins, 0.0, 1.0)

    def _mean_loss_by(self, pairs, bins: int, lo: float, hi: float):
        bins = max(int(bins), 1)
        span = max(hi - lo, 1e-12)
        sums = [0.0] * bins
        counts = [0] * bins
        for x, loss in pairs:
            idx = min(max(int((float(x) - lo) / span * bins), 0), bins - 1)
            sums[idx] += float(loss)
            counts[idx] += 1
        edges = [lo + span * i / bins for i in range(bins + 1)]
        means = [(sums[i] / counts[i]) if counts[i] else None
                 for i in range(bins)]
        return edges, means, counts

    def mean_loss_by_timestep(self, bins: int = 25, max_timestep: int = 1000):
        """Per-timestep-bin mean loss — which noise levels the model finds
        hard (reference mean-loss-by-sigma panel, gui.py:1896-1943)."""
        return self._mean_loss_by(self.ticket_loss, bins, 0.0,
                                  float(max_timestep))

    def mean_loss_by_sigma(self, bins: int = 25):
        return self._mean_loss_by(self.sigma_loss, bins, 0.0, 1.0)

    def status_line(self) -> str:
        parts = []
        if self.step_loss.last():
            step, loss = self.step_loss.last()
            parts.append(f"Step: {step} | Loss: {loss:.4f}")
        if self.sigmas:
            parts.append(f"Ticket: {self.timesteps[-1]} | "
                         f"Sigma: {self.sigmas[-1]:.6f}")
        elif self.timesteps:
            parts.append(f"Timestep: {self.timesteps[-1]}")
        if self.lr.last():
            parts.append(f"LR: {self.lr.last()[1]:.2e}")
        if self.grad_raw.last():
            parts.append(f"Grad: {self.grad_raw.last()[1]:.4f}")
        return " | ".join(parts)
