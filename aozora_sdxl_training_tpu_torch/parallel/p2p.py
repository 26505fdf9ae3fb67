"""Point-to-point hops between the ranks of a ``torch.distributed`` group.

One function, ``exchange``, carries the hops of both multi-rank Anima
paths: the KV and gradient shards of the SP ring
(``ops/ring_attention.py``) and the activations and their gradients
between GPipe stages (``parallel/pipeline.py``). It posts every send and
receive of one step together (``dist.batch_isend_irecv``) and waits for
all of them, so a rank never blocks its neighbour.

NCCL moves CUDA tensors itself, and gloo moves CPU tensors itself. Gloo's
``send``/``recv`` hand the tensor's data pointer to its TCP transport, which
reads and writes it from the host, so a CUDA tensor cannot go to gloo as it
is (the one-card runs: two gloo ranks on ``cuda:0``, since NCCL refuses two
ranks on one device). For a gloo group the hop of a CUDA tensor is
therefore staged through pinned host buffers: the device-to-host copy
before the send, the host-to-device copy after the receive; the compute
stays on the card. The group's backend picks the path (``staged``), not a
caught error.

``STATS`` counts, by caller, the hops this rank took part in and the bytes
it sent, and says whether they were staged; ``reset_stats`` clears it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()


def staged(group, device: torch.device) -> bool:
    """Whether a hop of tensors on ``device`` over ``group`` goes through
    pinned host buffers: a gloo group and a CUDA device."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def exchange(sends, recvs, group, kind: str = "hop") -> list:
    """Sends each ``(tensor, peer)`` of ``sends`` and receives into a new
    tensor shaped like each ``(like, peer)`` of ``recvs`` (``peer``: the
    rank in ``group``), all posted at once; returns the received tensors,
    on ``like``'s device. Every peer must post the matching receive or
    send in the same step."""
    if not sends and not recvs:
        return []
    device = (sends[0][0] if sends else recvs[0][0]).device
    via_host = staged(group, device)
    ops, out, host_out = [], [], []
    for t, peer in sends:
        t = t.contiguous()
        if via_host:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            t = host
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group))
    for like, peer in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          **({"pin_memory": True} if via_host else {"device": device}))
        host_out.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for buf in host_out:
        out.append(buf.to(device, non_blocking=True) if via_host else buf)
    count = STATS.setdefault(kind, {"hops": 0, "bytes_sent": 0, "staged": via_host})
    count["hops"] += 1
    count["bytes_sent"] += sum(t.numel() * t.element_size() for t, _ in sends)
    return out
