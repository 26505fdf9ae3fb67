"""Checkpoint diff forensics: tensor deltas + LoRA-merge detection.

Library form of the reference's Tk diff tool
(reference scripts/anima_diff_checker.py:145-1616): per-tensor
difference statistics between a base and a tuned checkpoint, randomized-SVD
spectra of the weight deltas, and the LoRA-merge heuristics (effective-rank
ratio, singular-value cliff, identical-tensor ratio) that flag a checkpoint
as a merged LoRA rather than a full fine-tune.  CSV export, no GUI.
"""

from __future__ import annotations

import csv
import json
from dataclasses import dataclass, field

import numpy as np

from ..ckpt.safetensors_io import read_header, read_tensor


@dataclass
class TensorDiff:
    key: str
    shape: tuple[int, ...]
    mean_abs_delta: float
    max_abs_delta: float
    rel_delta: float          # ||delta|| / ||base||
    identical: bool
    effective_rank: float | None = None
    rank_ratio: float | None = None
    sv_cliff: float | None = None


@dataclass
class DiffReport:
    tensors: list[TensorDiff] = field(default_factory=list)
    missing_in_tuned: list[str] = field(default_factory=list)
    extra_in_tuned: list[str] = field(default_factory=list)

    @property
    def identical_ratio(self) -> float:
        if not self.tensors:
            return 0.0
        return sum(t.identical for t in self.tensors) / len(self.tensors)

    def merge_artifact_verdict(self, rank_ratio_threshold: float = 0.25,
                               cliff_threshold: float = 10.0) -> dict:
        """LoRA-merge detection: low-effective-rank deltas with a sharp
        singular-value cliff across many attention/linear tensors, combined
        with a high identical-tensor ratio, indicate a merged LoRA
        (heuristics from anima_diff_checker.py:332+)."""
        analyzed = [t for t in self.tensors
                    if t.rank_ratio is not None and not t.identical]
        if not analyzed:
            return {"is_lora_merge": False, "reason": "no analyzable deltas"}
        low_rank = [t for t in analyzed if t.rank_ratio < rank_ratio_threshold]
        cliffed = [t for t in analyzed
                   if t.sv_cliff is not None and t.sv_cliff > cliff_threshold]
        low_rank_frac = len(low_rank) / len(analyzed)
        cliff_frac = len(cliffed) / len(analyzed)
        is_merge = (low_rank_frac > 0.6 and cliff_frac > 0.5) or (
            low_rank_frac > 0.8)
        return {
            "is_lora_merge": bool(is_merge),
            "low_rank_fraction": round(low_rank_frac, 4),
            "cliff_fraction": round(cliff_frac, 4),
            "identical_ratio": round(self.identical_ratio, 4),
            "analyzed_tensors": len(analyzed),
        }


def effective_rank_stats(delta: np.ndarray, probes: int = 64, seed: int = 0):
    """(effective_rank, rank_ratio, sv_cliff) from a randomized SVD sketch.

    effective_rank = entropy-based rank of the singular spectrum; cliff =
    largest adjacent singular-value ratio in the top of the spectrum.
    """
    m = delta.reshape(delta.shape[0], -1).astype(np.float32)
    k = min(probes, min(m.shape))
    if k < 2:
        return None, None, None
    rng = np.random.default_rng(seed)
    omega = rng.normal(size=(m.shape[1], k)).astype(np.float32)
    y = m @ omega                                   # (out, k)
    qmat, _ = np.linalg.qr(y)
    b = qmat.T @ m                                  # (k, in)
    sv = np.linalg.svd(b, compute_uv=False)
    sv = sv[sv > 0]
    if sv.size < 2:
        return None, None, None
    p = sv / sv.sum()
    eff_rank = float(np.exp(-(p * np.log(p)).sum()))
    rank_ratio = eff_rank / min(m.shape)
    ratios = sv[:-1] / np.maximum(sv[1:], 1e-12)
    sv_cliff = float(ratios[: max(1, k // 2)].max())
    return eff_rank, rank_ratio, sv_cliff


def diff_checkpoints(base_path, tuned_path, *, svd: bool = True,
                     svd_min_dim: int = 64, key_filter=None) -> DiffReport:
    base_header = read_header(base_path)
    tuned_header = read_header(tuned_path)
    report = DiffReport(
        missing_in_tuned=sorted(set(base_header) - set(tuned_header)),
        extra_in_tuned=sorted(set(tuned_header) - set(base_header)),
    )
    for key in sorted(set(base_header) & set(tuned_header)):
        if key_filter and not key_filter(key):
            continue
        spec = base_header[key]
        if spec["dtype"] not in ("F32", "F16", "BF16"):
            continue
        a = read_tensor(base_path, key).astype(np.float32)
        b = read_tensor(tuned_path, key).astype(np.float32)
        if a.shape != b.shape:
            report.extra_in_tuned.append(f"{key} (shape changed)")
            continue
        delta = b - a
        abs_delta = np.abs(delta)
        base_norm = float(np.linalg.norm(a))
        entry = TensorDiff(
            key=key, shape=tuple(a.shape),
            mean_abs_delta=float(abs_delta.mean()),
            max_abs_delta=float(abs_delta.max()),
            rel_delta=float(np.linalg.norm(delta) / max(base_norm, 1e-12)),
            identical=bool(abs_delta.max() == 0.0),
        )
        if (svd and not entry.identical and a.ndim == 2
                and min(a.shape) >= svd_min_dim):
            eff, ratio, cliff = effective_rank_stats(delta)
            entry.effective_rank, entry.rank_ratio, entry.sv_cliff = eff, ratio, cliff
        report.tensors.append(entry)
    return report


def per_block_summary(report: DiffReport) -> dict[str, dict]:
    """Mean relative delta grouped by block index (the per-block diagram)."""
    import re
    groups: dict[str, list[float]] = {}
    for t in report.tensors:
        m = re.search(r"(?:^|\.)(?:blocks|input_blocks|output_blocks|"
                      r"middle_block|down_blocks|up_blocks|mid_block)\.(\d+)",
                      t.key)
        group = m.group(0) if m else "other"
        groups.setdefault(group, []).append(t.rel_delta)
    return {g: {"mean_rel_delta": float(np.mean(v)), "tensors": len(v)}
            for g, v in sorted(groups.items())}


def export_csv(report: DiffReport, path) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["key", "shape", "mean_abs_delta", "max_abs_delta",
                         "rel_delta", "identical", "effective_rank",
                         "rank_ratio", "sv_cliff"])
        for t in report.tensors:
            writer.writerow([t.key, "x".join(map(str, t.shape)),
                             t.mean_abs_delta, t.max_abs_delta, t.rel_delta,
                             t.identical, t.effective_rank, t.rank_ratio,
                             t.sv_cliff])


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(
        description="Diff two checkpoints and detect LoRA-merge artifacts.")
    parser.add_argument("base")
    parser.add_argument("tuned")
    parser.add_argument("--csv", help="export per-tensor CSV")
    parser.add_argument("--no-svd", action="store_true")
    args = parser.parse_args(argv)
    report = diff_checkpoints(args.base, args.tuned, svd=not args.no_svd)
    verdict = report.merge_artifact_verdict()
    print(json.dumps({
        "tensors_compared": len(report.tensors),
        "identical_ratio": round(report.identical_ratio, 4),
        "missing_in_tuned": len(report.missing_in_tuned),
        "extra_in_tuned": len(report.extra_in_tuned),
        "merge_verdict": verdict,
        "per_block": per_block_summary(report),
    }, indent=2))
    if args.csv:
        export_csv(report, args.csv)
        print(f"CSV written to {args.csv}")


if __name__ == "__main__":
    main()
