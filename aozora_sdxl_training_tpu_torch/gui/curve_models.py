"""Headless editing models for the three training curves.

Copy of ``aozora_sdxl_training_tpu/gui/curve_models.py``, kept in the port so that the
port imports nothing of the JAX package.

The reference edits its LR curve, timestep-ticket histogram, and
timestep-loss-weight curve through custom-painted Qt widgets
(the reference's gui/gui.py:1956-2683).  The editing semantics — point
clamping, sorted-x invariants, add-in-largest-gap, endpoint locking,
largest-remainder ticket redistribution, and the standard presets — live here
as plain models so any frontend (tkinter shell, tests, scripts) produces
byte-identical preset JSON.

The *evaluation* of these curves during training lives elsewhere:
``train/curves.py`` (LR + loss-weight interpolation) and
``train/timestep_presets.py`` (distribution weights); these models only own
the edit/serialize behavior.
"""

from __future__ import annotations

import math

from ..train.timestep_presets import distribution_weights


def _largest_remainder(raw: list[float], total: int) -> list[int]:
    """Integerize ``raw`` (which sums ~total) preserving the exact total."""
    counts = [int(x) for x in raw]
    fracs = sorted(((raw[i] - counts[i], i) for i in range(len(raw))),
                   key=lambda t: t[0], reverse=True)
    for k in range(total - sum(counts)):
        counts[fracs[k][1]] += 1
    return counts


class LRCurveModel:
    """Editable LR-vs-progress polyline: points are ``[x(0..1), lr]``.

    Matches gui.py:1956-2251 LRCurveWidget: y clamps to the configured
    min/max LR bounds; points stay x-sorted; the first and last points are
    not removable; ``add_point`` bisects the widest x gap at the log-space
    midpoint LR; presets are Constant / Linear / Cosine with a fixed 5%%
    warmup (gui.py:2223-2251).
    """

    WARMUP_END = 0.05

    def __init__(self, points=None, *, min_lr: float = 1e-7,
                 max_lr: float = 1e-4):
        self.min_lr = float(min_lr)
        self.max_lr = float(max_lr) if max_lr > min_lr else min_lr + 1e-9
        self._points: list[list[float]] = []
        self.set_points(points or [[0.0, min_lr], [self.WARMUP_END, max_lr],
                                   [1.0, min_lr]])

    def set_bounds(self, min_lr: float, max_lr: float) -> bool:
        """Clamp existing points into new bounds; True if any moved."""
        self.min_lr = float(min_lr)
        self.max_lr = float(max_lr) if max_lr > min_lr else min_lr + 1e-9
        changed = False
        for p in self._points:
            clamped = max(self.min_lr, min(self.max_lr, p[1]))
            if clamped != p[1]:
                p[1] = clamped
                changed = True
        return changed

    def set_points(self, points) -> None:
        self._points = sorted(([float(x), float(y)] for x, y in points),
                              key=lambda p: p[0])

    def get_points(self) -> list[list[float]]:
        return [list(p) for p in self._points]

    def move_point(self, index: int, x: float, lr: float) -> None:
        if not 0 <= index < len(self._points):
            return
        lr = max(self.min_lr, min(self.max_lr, float(lr)))
        if index in (0, len(self._points) - 1):
            x = self._points[index][0]  # endpoints keep their x
        else:
            lo = self._points[index - 1][0]
            hi = self._points[index + 1][0]
            x = max(lo, min(hi, float(x)))
        self._points[index] = [x, lr]

    def add_point(self) -> int:
        """Insert at the midpoint of the widest x gap, log-midpoint LR."""
        if len(self._points) < 2:
            return -1
        max_gap, insert_idx = 0.0, -1
        for i in range(len(self._points) - 1):
            gap = self._points[i + 1][0] - self._points[i][0]
            if gap > max_gap:
                max_gap, insert_idx = gap, i + 1
        if insert_idx == -1:
            return -1
        prev, nxt = self._points[insert_idx - 1], self._points[insert_idx]
        log_min = math.log(max(self.min_lr, 1e-12))
        new_lr = math.exp(max(log_min,
                              (math.log(max(prev[1], 1e-12)) +
                               math.log(max(nxt[1], 1e-12))) / 2))
        self._points.insert(insert_idx, [(prev[0] + nxt[0]) / 2, new_lr])
        return insert_idx

    def remove_point(self, index: int) -> bool:
        if 0 < index < len(self._points) - 1:
            self._points.pop(index)
            return True
        return False

    def set_standard_preset(self, mode: str) -> None:
        min_lr, max_lr, w = self.min_lr, self.max_lr, self.WARMUP_END
        if mode == "Constant":
            points = [[0.0, min_lr], [w, max_lr], [0.95, max_lr], [1.0, min_lr]]
        elif mode == "Linear":
            points = [[0.0, min_lr], [w, max_lr], [1.0, min_lr]]
        elif mode == "Cosine":
            points = [[0.0, min_lr], [w, max_lr]]
            for index in range(1, 21):
                progress = index / 20
                points.append([
                    w + progress * (1.0 - w),
                    min_lr + (max_lr - min_lr) * 0.5
                    * (1.0 + math.cos(math.pi * progress)),
                ])
        else:
            raise ValueError(f"Unknown learning-rate preset: {mode}")
        self.set_points(points)


class TimestepHistogramModel:
    """Editable per-bin timestep ticket allocation.

    Matches gui.py:2253-2432 TimestepHistogramWidget: bins of ``bin_size``
    timesteps out of 1000; ``set_total_steps`` rescales counts preserving
    their shape via largest-remainder rounding; ``generate_from_weights``
    converts a normalized weight vector to exact-integer counts the same
    way; a mismatched saved allocation resets to a uniform split.
    """

    TOTAL_TIMESTEPS = 1000

    def __init__(self, *, bin_size: int = 50, max_tickets: int = 1000):
        self.bin_size = max(1, int(bin_size))
        self.max_tickets = max(1, int(max_tickets))
        self.counts: list[int] = []
        self._init_bins()

    def _num_bins(self) -> int:
        return max(math.ceil(self.TOTAL_TIMESTEPS / self.bin_size), 1)

    def _init_bins(self) -> None:
        n = self._num_bins()
        base, rem = divmod(self.max_tickets, n)
        self.counts = [base + (1 if i < rem else 0) for i in range(n)]

    def set_total_steps(self, steps: int) -> None:
        steps = max(int(steps), 1)
        self.max_tickets = steps
        cur = sum(self.counts)
        if not self.counts or cur == 0:
            self._init_bins()
            return
        raw = [(c / cur) * steps for c in self.counts]
        self.counts = _largest_remainder(raw, steps)

    def set_bin_size(self, size: int) -> None:
        if size <= 0:
            return
        self.bin_size = int(size)
        self._init_bins()

    def set_allocation(self, alloc) -> None:
        if not alloc or "bin_size" not in alloc or "counts" not in alloc:
            self._init_bins()
            return
        self.bin_size = max(1, int(alloc["bin_size"]))
        counts = list(alloc["counts"])
        if len(counts) != self._num_bins():
            self._init_bins()
            return
        self.counts = [int(c) for c in counts]
        total = sum(self.counts)
        if total > 0:
            self.max_tickets = total

    def get_allocation(self) -> dict:
        return {"bin_size": self.bin_size, "counts": list(self.counts)}

    def generate_from_weights(self, weights) -> None:
        weights = list(weights)
        n = len(self.counts)
        if n == 0 or not weights:
            return
        tw = sum(weights) or 1
        raw = [(w / tw) * self.max_tickets for w in weights[:n]]
        raw += [0.0] * (n - len(raw))
        self.counts = _largest_remainder(raw, self.max_tickets)

    def apply_distribution(self, mode: str, **kwargs) -> None:
        """Fill from a named distribution (Wave/Logit-Normal/Beta/Odds-...).

        Uses the same weight functions the trainer's sampler uses
        (train/timestep_presets.py), so GUI preview and training agree.
        """
        self.generate_from_weights(
            distribution_weights(mode, self.bin_size, **kwargs))


class LossWeightCurveModel:
    """Editable timestep-loss-weight polyline, or the "bell" preset token.

    Matches gui.py:2434-2683 TimestepLossWeightCurveWidget: x in [0,1] with
    endpoints pinned to exactly 0 and 1, y clamped to [0, 2]; serializes as
    rounded point pairs, or ``{"preset": "bell"}`` when the analytic bell is
    active (evaluated in train/curves.py); ships the same Min-SNR-like
    preset table (gui.py:2496-2507) and the 9-point bell preview sampling
    (gui.py:2509-2516).
    """

    MIN_WEIGHT = 0.0
    MAX_WEIGHT = 2.0

    MIN_SNR_LIKE = [
        [0.0, 0.0043], [0.025025, 0.1198], [0.05005, 0.2544],
        [0.075075, 0.4107], [0.1001, 0.5914], [0.125125, 0.7999],
        [0.15015, 1.0], [1.0, 1.0],
    ]

    def __init__(self, points=None):
        self._preset: str | None = None
        self._points: list[list[float]] = [[0.0, 1.0], [1.0, 1.0]]
        if points is not None:
            self.set_points(points)

    def set_points(self, points) -> None:
        self._preset = None
        if isinstance(points, dict):
            if str(points.get("preset", "")).lower() == "bell":
                self._preset = "bell"
                points = self.bell_preview_points()
            else:
                points = []
        cleaned = []
        for p in points or []:
            try:
                x = max(0.0, min(1.0, float(p[0])))
                y = max(self.MIN_WEIGHT, min(self.MAX_WEIGHT, float(p[1])))
                cleaned.append([x, y])
            except (TypeError, ValueError, IndexError):
                continue
        if len(cleaned) < 2:
            cleaned = [[0.0, 1.0], [1.0, 1.0]]
        cleaned.sort(key=lambda p: p[0])
        cleaned[0][0] = 0.0
        cleaned[-1][0] = 1.0
        self._points = cleaned

    def get_points(self):
        if self._preset == "bell":
            return {"preset": "bell"}
        return [[round(p[0], 8), round(p[1], 4)] for p in self._points]

    def apply_bell_preset(self) -> None:
        self.set_points({"preset": "bell"})

    def apply_min_snr_like_preset(self) -> None:
        self.set_points([list(p) for p in self.MIN_SNR_LIKE])

    @staticmethod
    def bell_preview_points() -> list[list[float]]:
        steps = 1000
        values = [math.exp(-2.0 * ((i - steps / 2) / steps) ** 2)
                  for i in range(steps)]
        y_min = min(values)
        denom = sum(v - y_min for v in values) or 1.0
        scale = steps / denom
        sample_indices = [0, 125, 250, 375, 500, 625, 750, 875, 999]
        return [[i / (steps - 1), (values[i] - y_min) * scale]
                for i in sample_indices]

    def move_point(self, index: int, x: float, y: float) -> None:
        if not 0 <= index < len(self._points):
            return
        self._preset = None
        y = max(self.MIN_WEIGHT, min(self.MAX_WEIGHT, float(y)))
        if index in (0, len(self._points) - 1):
            x = self._points[index][0]
        else:
            x = max(self._points[index - 1][0],
                    min(self._points[index + 1][0], float(x)))
        self._points[index] = [x, y]

    def add_point(self) -> int:
        self._preset = None
        if len(self._points) < 2:
            return -1
        max_gap, insert_idx = 0.0, -1
        for i in range(len(self._points) - 1):
            gap = self._points[i + 1][0] - self._points[i][0]
            if gap > max_gap:
                max_gap, insert_idx = gap, i + 1
        if insert_idx == -1:
            return -1
        prev, nxt = self._points[insert_idx - 1], self._points[insert_idx]
        self._points.insert(insert_idx,
                            [(prev[0] + nxt[0]) / 2, (prev[1] + nxt[1]) / 2])
        return insert_idx

    def remove_point(self, index: int) -> bool:
        if 0 < index < len(self._points) - 1:
            self._preset = None
            self._points.pop(index)
            return True
        return False
