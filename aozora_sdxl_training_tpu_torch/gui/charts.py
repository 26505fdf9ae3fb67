"""Headless chart series model — the data half of the reference's GraphPanel.

Copy of ``aozora_sdxl_training_tpu/gui/charts.py``, kept in the port so that the
port imports nothing of the JAX package.

The reference implements zoom/pan charts as a QPainter widget
(the reference's gui/gui.py:1069-1573).  Here the data-management semantics
(sorted insert-or-replace by x, min-max bucket compaction bounded by
``max_points``, visible-window slicing, min-max downsampling for draw) live in
a toolkit-free model so the tkinter shell, tests, and any future frontend
share one implementation.

Semantics matched to the reference:
- ``append(x, y)``: out-of-order x inserts sorted; duplicate x replaces the
  point (gui.py:1133-1147 ``append_data``).
- compaction: when a series exceeds ``max_points``, shrink to
  ``max(256, max_points // 2)`` by keeping first/last points and the per-bucket
  min and max of everything between (gui.py:1193-1217 ``_compact_line``).
- ``visible_slice(lo, hi)``: bisect the sorted x values, widened by one point
  each side so lines enter/exit the viewport smoothly (gui.py:1219-1236).
- ``sample(points, max_points)``: same min-max bucketing applied at draw time
  to the visible slice (gui.py:1238-1267 ``_sample_visible_points``).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field


def _minmax_buckets(points: list[tuple[float, float]], target: int):
    """Keep per-bucket y-min/y-max points; preserves spikes that plain
    striding would alias away."""
    count = len(points)
    bucket_count = max(2, target // 2)
    bucket_size = count / bucket_count
    kept: list[tuple[float, float]] = []
    for bucket in range(bucket_count):
        start = int(bucket * bucket_size)
        end = count if bucket == bucket_count - 1 else int((bucket + 1) * bucket_size)
        segment = points[start:end]
        if not segment:
            continue
        min_i = min(range(len(segment)), key=lambda i: segment[i][1])
        max_i = max(range(len(segment)), key=lambda i: segment[i][1])
        for local_i in sorted({min_i, max_i}):
            kept.append(segment[local_i])
    return kept


@dataclass
class Series:
    label: str
    color: str = "#c1845b"
    max_points: int = 2000
    linewidth: int = 2
    line_style: str = "solid"
    visible: bool = True
    version: int = 0
    data: list[tuple[float, float]] = field(default_factory=list)
    x_values: list[float] = field(default_factory=list)

    def append(self, x: float, y: float) -> None:
        if self.x_values and x <= self.x_values[-1]:
            pos = bisect_left(self.x_values, x)
            if pos < len(self.x_values) and self.x_values[pos] == x:
                self.data[pos] = (x, y)
            else:
                self.data.insert(pos, (x, y))
                self.x_values.insert(pos, x)
        else:
            self.data.append((x, y))
            self.x_values.append(x)
        self.version += 1
        if len(self.data) > self.max_points:
            self._compact()

    def _compact(self) -> None:
        target = max(256, self.max_points // 2)
        if len(self.data) <= target:
            return
        compacted = [self.data[0]]
        compacted.extend(_minmax_buckets(self.data[1:-1], target - 2))
        compacted.append(self.data[-1])
        self.data = compacted
        self.x_values = [x for x, _ in compacted]
        self.version += 1

    def visible_slice(self, view_min: float, view_max: float):
        data = self.data
        if not data:
            return []
        if len(data) <= 2:
            return data[:]
        start = max(0, bisect_left(self.x_values, view_min) - 1)
        end = min(len(data), bisect_right(self.x_values, view_max) + 1)
        if start >= end:
            return data[-1:] if start >= len(data) else data[start:start + 1]
        return data[start:end]

    def clear(self) -> None:
        self.data.clear()
        self.x_values.clear()
        self.version += 1


def sample(points, max_points: int):
    """Min-max downsample a visible slice to at most ~max_points for drawing."""
    points = list(points)
    if len(points) <= max_points:
        return points
    return _minmax_buckets(points, max_points)


@dataclass
class ViewWindow:
    """Zoom/pan state over the x axis — the interaction half of the
    reference's GraphPanel (gui.py:1276-1379 wheelEvent/mouseMoveEvent):
    wheel zooms about the cursor, drag pans, double-click resets to
    auto-follow (the window tracks the live data range while auto)."""

    lo: float | None = None     # None/None = auto-follow the data range
    hi: float | None = None
    MIN_SPAN: float = 1e-9

    @property
    def is_auto(self) -> bool:
        return self.lo is None or self.hi is None

    def resolve(self, data_range: tuple[float, float]) -> tuple[float, float]:
        if self.is_auto:
            return data_range
        return (self.lo, self.hi)

    def zoom(self, factor: float, center_frac: float,
             data_range: tuple[float, float]) -> None:
        """factor < 1 zooms in; center_frac in [0,1] is the cursor position
        within the current window (kept fixed on screen)."""
        lo, hi = self.resolve(data_range)
        span = max(hi - lo, self.MIN_SPAN)
        new_span = max(span * max(factor, 1e-6), self.MIN_SPAN)
        center = lo + span * min(max(center_frac, 0.0), 1.0)
        self.lo = center - new_span * center_frac
        self.hi = self.lo + new_span
        # zooming out past the data returns to auto-follow
        dlo, dhi = data_range
        if self.lo <= dlo and self.hi >= dhi:
            self.reset()

    def pan(self, delta_frac: float,
            data_range: tuple[float, float]) -> None:
        """Shift the window by delta_frac of its span (drag)."""
        lo, hi = self.resolve(data_range)
        span = hi - lo
        shift = span * delta_frac
        self.lo, self.hi = lo + shift, hi + shift

    def reset(self) -> None:
        self.lo = self.hi = None


class ChartModel:
    """A titled collection of series with a shared x data range."""

    def __init__(self, title: str, y_label: str = ""):
        self.title = title
        self.y_label = y_label
        self.series: list[Series] = []
        self.view = ViewWindow()

    def add_line(self, label: str, color: str = "#c1845b", *,
                 max_points: int = 2000, linewidth: int = 2,
                 line_style: str = "solid") -> int:
        self.series.append(Series(label=label, color=color,
                                  max_points=max_points, linewidth=linewidth,
                                  line_style=line_style))
        return len(self.series) - 1

    def append(self, index: int, x: float, y: float) -> None:
        if 0 <= index < len(self.series):
            self.series[index].append(x, y)

    def set_visible(self, index: int, visible: bool) -> None:
        if 0 <= index < len(self.series):
            self.series[index].visible = bool(visible)

    def clear(self) -> None:
        for s in self.series:
            s.clear()

    def data_range(self) -> tuple[float, float]:
        firsts = [s.data[0][0] for s in self.series if s.data]
        lasts = [s.data[-1][0] for s in self.series if s.data]
        if not firsts:
            return (0.0, 100.0)
        lo, hi = min(firsts), max(lasts)
        return (lo, hi if hi > lo else lo + 1)

    # --- zoom / pan / hover (GraphPanel interaction semantics) ---

    def view_range(self) -> tuple[float, float]:
        return self.view.resolve(self.data_range())

    def zoom_at(self, center_frac: float, factor: float) -> None:
        self.view.zoom(factor, center_frac, self.data_range())

    def pan_fraction(self, delta_frac: float) -> None:
        self.view.pan(delta_frac, self.data_range())

    def reset_view(self) -> None:
        self.view.reset()

    def nearest_point(self, x: float):
        """(series_index, (x, y)) of the data point nearest to x across
        visible series — the hover readout (gui.py:1390-1420)."""
        best = None
        for i, s in enumerate(self.series):
            if not s.visible or not s.data:
                continue
            pos = bisect_left(s.x_values, x)
            for p in (pos - 1, pos):
                if 0 <= p < len(s.data):
                    d = abs(s.data[p][0] - x)
                    if best is None or d < best[0]:
                        best = (d, i, s.data[p])
        return (best[1], best[2]) if best else None
