"""The collectives the sharded steps send, on either backend.

NCCL takes CUDA tensors.  gloo all-reduces and broadcasts CUDA tensors,
but its all-gather and its point-to-point ops take CPU tensors only.  So on
a gloo group a CUDA tensor's all-gather and sends / receives are staged
through the host here: copied to the host, exchanged, and copied back.
The choice is made by the group's backend name, before the call; the
compute stays on the card either way.  `staged_bytes` counts the bytes
each kind of collective copied across the host boundary (both ways).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

staged_bytes = {"all_gather": 0, "p2p": 0}


def reset_staged_bytes() -> None:
    for k in staged_bytes:
        staged_bytes[k] = 0


def stages_through_host(group, t: torch.Tensor) -> bool:
    """Does a collective of `t` on `group` go through the host (a CUDA
    tensor on a gloo group)?"""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (equal shapes), in the group's rank order, on
    `t`'s device."""
    n = dist.get_world_size(group)
    if n == 1:
        return [t]
    if stages_through_host(group, t):
        host = t.detach().cpu().contiguous()
        outs = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(outs, host, group=group)
        staged_bytes["all_gather"] += host.nbytes * (n + 1)
        return [o.to(t.device) for o in outs]
    outs = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(outs, t.contiguous(), group=group)
    return outs


def send_recv(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]], group) -> None:
    """One batch of point-to-point ops on `group`: each (tensor, peer) of
    `sends` goes to that group rank, each (out, peer) of `recvs` is filled
    from it; returns when all have completed."""
    tensors = [t for t, _ in sends] + [t for t, _ in recvs]
    if not tensors:
        return
    staged = stages_through_host(group, tensors[0])
    ops, landed = [], []
    for t, peer in sends:
        buf = t.contiguous()
        if staged:
            buf = buf.cpu()
            staged_bytes["p2p"] += buf.nbytes
        ops.append(dist.P2POp(dist.isend, buf, dist.get_global_rank(group, peer), group))
    for out, peer in recvs:
        buf = torch.empty(out.shape, dtype=out.dtype) if staged else out
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
        landed.append((out, buf))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        for out, buf in landed:
            out.copy_(buf)
            staged_bytes["p2p"] += buf.nbytes
