"""Pipelined all-gather matmul (collective matmul): compute/comm overlap,
the counterpart of repro.distributed.collective_matmul.

Y = X @ W with X row-sharded (m/P, d) and W column-sharded as P stacked
blocks (d, n/P): instead of all-gathering W then multiplying (a barrier),
each rank multiplies the W block it currently holds while passing it to
the next rank — P steps, the transfer hidden behind the matmul. This is
the standard Megatron-style TP overlap, as a building block on a process
group. Both forms multiply with torch.matmul (the reference computes its
products outside any Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def allgather_matmul_overlapped(x_shard: torch.Tensor,
                                w_block: torch.Tensor,
                                group=None) -> torch.Tensor:
    """On each rank r of `group` (size P):

    x_shard (m_local, d) — this rank's rows of X;
    w_block (d, n_block) — this rank's column block r of W.
    Returns y_local (m_local, P * n_block) = x_shard @ W (all columns), in
    f32. At step i rank r holds block (r - i) mod P: it multiplies it while
    batch_isend_irecv passes it to rank r + 1 (and takes the next from
    r - 1); P steps, no all-gather.
    """
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    n_block = w_block.shape[1]
    nxt = dist.get_global_rank(group, (r + 1) % p) if group is not None \
        else (r + 1) % p
    prv = dist.get_global_rank(group, (r - 1) % p) if group is not None \
        else (r - 1) % p
    acc = torch.zeros((x_shard.shape[0], p * n_block), dtype=torch.float32,
                      device=x_shard.device)
    blk = w_block.contiguous()
    for i in range(p):
        src = (r - i) % p
        reqs, recv = [], None
        if i + 1 < p:                  # the pass overlaps this product
            recv = torch.empty_like(blk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, blk, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
        acc[:, src * n_block:(src + 1) * n_block] = \
            torch.matmul(x_shard, blk).to(torch.float32)
        for req in reqs:
            req.wait()
        if recv is not None:
            blk = recv
    return acc


def allgather_matmul_barrier(x_shard: torch.Tensor, w_block: torch.Tensor,
                             group=None) -> torch.Tensor:
    """Baseline: all-gather W fully (all_gather_into_tensor), then one
    matmul (the barrier the overlapped form removes)."""
    p = dist.get_world_size(group)
    d, n_block = w_block.shape
    gathered = torch.empty((p * d, n_block), dtype=w_block.dtype,
                           device=w_block.device)     # the blocks stacked
    dist.all_gather_into_tensor(gathered, w_block.contiguous(), group=group)
    w_all = gathered.reshape(p, d, n_block).permute(1, 0, 2) \
        .reshape(d, p * n_block)                      # (d, n)
    return torch.matmul(x_shard, w_all).to(torch.float32)
