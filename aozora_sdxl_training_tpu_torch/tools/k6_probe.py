"""Where K6's time goes on one card (csrc/groupnorm_silu.cu).

    python -m aozora_sdxl_training_tpu_torch.tools.k6_probe [--out FILE.json]

Run from the root of a checkout on a machine with an NVIDIA GPU. Three
parts, each printed:

1. phases: builds a copy of the source with a %globaltimer stamp at each
   phase boundary (thread 0 of every block) into csrc/build/, runs each
   layout once at three SDXL_BASE sites (32x32x640, 64x64x1280,
   128x128x960; B=1, bf16) and prints, over the blocks, each phase's median
   and largest duration, the kernel's span and the spread of block starts.
2. clusters: the runtime's count of NCHW clusters the card holds at once,
   by cluster size and shared memory a CTA.
3. plans: the 34 resnet sites of one SDXL_BASE forward at 1024px as a CUDA
   graph, under variants of the launch plans' constants (NCHW: the cluster
   size limit and the fewest vectors a CTA; NHWC: the most chunks a batch
   element).

Imports no JAX. The card tests and chip_smoke.py hold the kernels' results;
this only times them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..models.sdxl.arch import SDXL_BASE, param_shapes
from ..ops import cuda_build
from ..ops import groupnorm_silu as gn

SITES = ((32, 640), (64, 1280), (128, 960))
NCHW_PHASES = ("entry", "copies issued", "summed", "block-reduced", "cluster barrier",
               "cluster-folded", "coefficients", "applied", "exit")
STATS_PHASES = ("entry", "rows loaded", "channels folded", "groups folded", "arrived",
                "last block folded")
SLOTS = 8192          # stamp rows: NCHW blocks from 0, NHWC stats from 4096, apply from 6144
STAMPS = {
    # (anchor, text put before it, text put after it)
    "nchw": [("  cg::cluster_group cluster = cg::this_cluster();\n",
              "  const int probe_id = blockIdx.x;\n  STAMP(0);\n", ""),
             ("  if constexpr (V == 1) __syncthreads();\n", "", "  STAMP(1);\n"),
             ("  a1 = warp_sum(a1);\n", "  STAMP(2);\n", ""),
             ("  cluster.sync();   // every CTA's part is written\n", "  STAMP(3);\n",
              "  STAMP(4);\n"),
             ("  cluster_arrive();   // done reading the other CTAs' shared memory\n",
              "  STAMP(5);\n", ""),
             ("  ChanWalk w(lo + tid * V, NCHW_THREADS * V, HW);\n", "  STAMP(6);\n", ""),
             ("  cluster_wait();   // no CTA leaves while another may read its part\n",
              "  STAMP(7);\n", "  STAMP(8);\n")],
    "stats": [("  __shared__ bool is_last;\n", "",
               "  const int probe_id = 4096 + blockIdx.x;\n  STAMP(0);\n"),
              ("  // fold the rows of each channel", "  STAMP(1);\n", ""),
              ("  // ... then the channels of each group", "  STAMP(2);\n", ""),
              ("  // the last block of this batch element to finish folds every chunk\n",
               "  STAMP(3);\n", ""),
              ("  if (!is_last) return;\n", "  STAMP(4);\n", ""),
              ("\n// ---- 2b. NHWC: normalise, affine, SiLU ----", "", "")],
    "apply": [("  const int tx = threadIdx.x % cols_tile, ty = threadIdx.x / cols_tile;\n",
               "  const int probe_id = 6144 + blockIdx.y;\n  STAMP(0);\n", ""),
              ("    Vec<T, V>::store(y + base + (size_t)r * C, v);\n  }\n", "",
               "  STAMP(1);\n")],
}
PROBE = f'''
__device__ unsigned long long g_probe[{SLOTS}][12];
#define STAMP(i) do {{ unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  if (threadIdx.x == 0 && probe_id < {SLOTS}) g_probe[probe_id][i] = t_; }} while (0)
'''
PROBE_C = '''
extern "C" int aozora_gn_probe_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  return e != cudaSuccess ? (int)e : (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int aozora_gn_probe_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_probe);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(g_probe));
}
'''


def instrumented_source(src: str) -> str:
    head = "namespace {\n\nusing bf16 = __nv_bfloat16;\n"
    if head not in src:
        raise RuntimeError("k6_probe: the source's layout changed (namespace head)")
    src = src.replace(head, head + PROBE, 1)
    for kernel, marks in STAMPS.items():
        for anchor, before, after in marks:
            if src.count(anchor) != 1:
                raise RuntimeError(f"k6_probe: anchor of {kernel} not found once: {anchor!r}")
            if anchor.startswith("\n// ---- 2b."):   # the stats kernel's closing brace
                end = src.index(anchor)
                close = src.rindex("}\n", 0, end)
                src = src[:close] + "  STAMP(5);\n" + src[close:]
                continue
            src = src.replace(anchor, before + anchor + after, 1)
    return src + PROBE_C


def build_probe() -> ctypes.CDLL:
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / "groupnorm_silu_probe.cu"
    so = cuda_build.BUILD_DIR / "groupnorm_silu_probe.so"
    cu.write_text(instrumented_source((cuda_build.CSRC / "groupnorm_silu.cu").read_text()))
    # the source includes nothing from csrc/, so the copy builds where it lies
    out = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the probe copy:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.aozora_group_norm_silu.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, f, p]
    lib.aozora_group_norm_silu.restype = i
    lib.aozora_group_norm_silu_nchw.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.aozora_group_norm_silu_nchw.restype = i
    lib.aozora_group_norm_silu_nchw_max_clusters.argtypes = [i, i, i, i, i, i]
    lib.aozora_group_norm_silu_nchw_max_clusters.restype = i
    lib.aozora_gn_error_string.argtypes = [i]
    lib.aozora_gn_error_string.restype = ctypes.c_char_p
    lib.aozora_gn_probe_read.argtypes = [p]
    for fn in (lib.aozora_gn_probe_read, lib.aozora_gn_probe_clear):
        fn.restype = i
    return lib


def phase_report(rows: np.ndarray, names) -> dict:
    rows = rows[rows[:, 0] > 0]
    t0 = rows[:, 0].min()
    out = {"blocks": int(len(rows)), "span_us": float((rows.max() - t0) / 1e3),
           "start_spread_us": float((rows[:, 0].max() - t0) / 1e3)}
    for k in range(1, len(names)):
        d = (rows[:, k] - rows[:, k - 1])[rows[:, k] > 0] / 1e3
        if len(d):
            out[f"{names[k - 1]} -> {names[k]}"] = (float(np.median(d)), float(d.max()))
    return out


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms of ``fn``'s launches, captured once in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def forward_sites() -> list[tuple[int, int]]:
    """(side, C) of the 34 resnet norm1/norm2 sites of one SDXL_BASE forward
    at 1024px."""
    sites = []
    for name, (shape, _) in param_shapes(SDXL_BASE).items():
        if "resnets" in name and name.endswith((".norm1.weight", ".norm2.weight")):
            part, level = name.split(".")[:2]
            sites.append((32 if part == "mid_block" else 128 >> int(level)
                          if part == "down_blocks" else 32 << int(level), shape[0]))
    return sites


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_probe: needs an NVIDIA GPU")
        return 1
    report = {"device": torch.cuda.get_device_name(0)}
    g = torch.Generator(device="cuda").manual_seed(1)

    def inputs(side, c):
        return (torch.randn(1, c, side, side, device="cuda", generator=g).to(torch.bfloat16),
                torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"))

    saved_lib = gn._library()
    probe = build_probe()
    buf = np.zeros((SLOTS, 12), dtype=np.uint64)

    def stamped(fn, *a):
        for _ in range(3):
            fn(*a)
        torch.cuda.synchronize()
        if probe.aozora_gn_probe_clear() != 0:
            raise RuntimeError("k6_probe: clearing the stamps failed")
        fn(*a)
        if probe.aozora_gn_probe_read(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise RuntimeError("k6_probe: reading the stamps failed")
        return buf.astype(np.int64)

    gn._lib, gn._plans = probe, {}
    try:
        report["phases"] = {}
        for side, c in SITES:
            x, s, b = inputs(side, c)
            label = f"{side}x{side}x{c}"
            nchw = phase_report(stamped(gn.group_norm_silu_nchw_forward, x, s, b, 32)[:4096],
                                NCHW_PHASES)
            d = stamped(gn.group_norm_silu_forward, x.permute(0, 2, 3, 1).contiguous(), s, b, 32)
            report["phases"][label] = {
                "nchw": nchw, "nhwc_stats": phase_report(d[4096:6144], STATS_PHASES),
                "nhwc_apply": phase_report(d[6144:], ("entry", "exit"))}
        report["clusters"] = {
            f"cluster {cs}, {kb} KB a CTA": probe.aozora_group_norm_silu_nchw_max_clusters(
                0, 1, 960, 32, cs, kb * 512 - 120)
            for cs in (1, 2, 4, 8) for kb in (112, 96, 74, 56, 40)}
    finally:
        gn._lib, gn._plans = saved_lib, {}

    # one input a site, as chip_smoke.py times them (a site repeated on the
    # same input would find it in L2)
    sites = forward_sites()
    data = [inputs(*k) for k in sites]
    nhwc_data = [(x.permute(0, 2, 3, 1).contiguous(), s, b) for x, s, b in data]
    consts = {k: getattr(gn, k) for k in ("MAX_CLUSTER", "_MIN_SLICE_VECTORS", "_MAX_CHUNKS")}
    variants = [("nchw", {}), ("nchw", {"MAX_CLUSTER": 4}),
                *(("nchw", {"_MIN_SLICE_VECTORS": v}) for v in (256, 512, 2048)),
                ("nhwc", {}), *(("nhwc", {"_MAX_CHUNKS": v}) for v in (128, 512))]
    report["plans"] = []
    try:
        for layout, change in variants:
            for k, v in {**consts, **change}.items():
                setattr(gn, k, v)
            gn._plans.clear()
            fn = gn.group_norm_silu_nchw_forward if layout == "nchw" else gn.group_norm_silu_forward
            src = data if layout == "nchw" else nhwc_data
            ms = graph_ms(lambda: [fn(*args, 32) for args in src])
            report["plans"].append({"layout": layout, "change": change or "as committed",
                                    "ms_34_sites": ms})
    finally:
        for k, v in consts.items():
            setattr(gn, k, v)
        gn._plans.clear()

    for label, layouts in report["phases"].items():
        for name, phases in layouts.items():
            print(f"{label} {name}: " + "; ".join(
                f"{k} {v[0]:.2f} (max {v[1]:.2f}) us" if isinstance(v, tuple) else f"{k} {v:g}"
                for k, v in phases.items()))
    print("clusters held at once: " + "; ".join(f"{k}: {v}" for k, v in report["clusters"].items()))
    for row in report["plans"]:
        print(f"plan {row['layout']} {row['change']}: {row['ms_34_sites']:.4f} ms for 34 sites")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
