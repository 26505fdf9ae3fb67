"""Probe of point-to-point hops between two gloo ranks on one CUDA card.

    python -m aozora_sdxl_training_tpu_torch.tools.p2p_probe [--out f.json]

Starts two ranks on ``cuda:0`` (gloo, a ``file://`` store) for each case
and has rank 0 send rank 1 a CUDA tensor of 1 Mi elements made from a
seed: ``raw`` hands the CUDA tensors to gloo's ``isend``/``irecv`` as they
are, ``exchange`` goes through ``parallel.p2p.exchange`` (which stages a
gloo hop through pinned host buffers). Each case runs in fresh processes
that are killed after 60 s, in fp32 and bf16, and reports whether the
received bytes equal the sent ones, or the error. Prints one JSON object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N = 1 << 20
TIMEOUT_S = 60.0


def _rank(case: str, dtype_name: str, store: str) -> int:
    import torch
    import torch.distributed as dist
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=2)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(7)
    sent = torch.randn(N, generator=gen, device="cuda").to(dtype)
    try:
        if case == "raw":
            if rank == 0:
                dist.isend(sent, 1).wait()
                got = sent
            else:
                got = torch.empty_like(sent)
                dist.irecv(got, 0).wait()
        else:
            from aozora_sdxl_training_tpu_torch.parallel.p2p import exchange
            got = (exchange([(sent, 1)], [], dist.group.WORLD)[:1] or [sent]) if rank == 0 \
                else exchange([], [(sent, 0)], dist.group.WORLD)
            got = got[0]
        torch.cuda.synchronize()
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        same = bool(torch.equal(got.view(bits), sent.view(bits)))
        print(json.dumps({"rank": rank, "ok": same, "device": str(got.device)}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _case(case: str, dtype_name: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="p2p_probe_") as tmp:
        env = {**os.environ, "WORLD_SIZE": "2", "GLOO_SOCKET_IFNAME": "lo",
               "PYTHONPATH": str(Path(__file__).resolve().parents[2])}
        cmd = [sys.executable, "-m", "aozora_sdxl_training_tpu_torch.tools.p2p_probe",
               "--rank", case, dtype_name, f"file://{tmp}/store"]
        procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(2)]
        t0, results = time.monotonic(), []
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, TIMEOUT_S - (time.monotonic() - t0)))
                results.append((p.returncode, out, err))
            except subprocess.TimeoutExpired:
                results.append((None, "", "timed out"))
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for code, out, err in results:
        last = [line for line in out.splitlines() if line.startswith("{")]
        ranks.append(json.loads(last[-1]) if code == 0 and last
                     else {"exit": code, "error": (err.strip().splitlines() or [""])[-1][:300]})
    return {"case": case, "dtype": dtype_name, "elements": N, "ranks": ranks,
            "ok": all(r.get("ok") is True for r in ranks)}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if args[:1] == ["--rank"]:
        return _rank(*args[1:4])
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("p2p_probe: needs a CUDA device")
    cases = [_case(c, d) for c in ("raw", "exchange") for d in ("float32", "bfloat16")]
    text = json.dumps({"cases": cases})
    if args[:1] == ["--out"]:
        Path(args[1]).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
