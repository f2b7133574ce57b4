"""Compute/communication overlap: ring collective matmuls over one mesh
axis (counterpart of the reference's ``parallel/overlap.py``).

The paper hides NoI traffic under compute by pipelining the ReRAM macro
and overlapping MHA with FF (§4.2).  The mesh analogue is the *collective
matmul*: a bulk ``all_gather(x)`` followed by the matmul serialises wire
time; instead each rank multiplies the shard it holds while the next shard
travels around the ring (``dist.batch_isend_irecv``, the counterpart of
``ppermute``), so the transfer of shard i+1 is hidden under the product of
shard i.  The ring is a *static* Python loop of G steps (G the axis size):
G products and G-1 transfers a rank.

Two patterns, matching the paper's two FF streaming directions:
- ``allgather_matmul``   — up-projection: gather sequence-sharded
  activations into the weight-stationary plane ("MC → ReRAM-macro head");
- ``reduce_scatter_matmul`` — down-projection: partial sums ring-reduced
  back out ("ReRAM-macro tail → MC").

Both take and return DTensors on a ``DeviceMesh``; every rank of the mesh
calls them.  On a one-rank axis they are a product and no transfer.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.api import to_placements


def _ring(mesh, axis: str):
    """(axis size G, this rank's index on it, the rank it sends to, the
    rank it receives from: index - 1 and index + 1 around the ring, the
    reference's permutation ``j -> j - 1``)."""
    d = mesh.mesh_dim_names.index(axis)
    group = mesh.get_group(d)
    ranks = dist.get_process_group_ranks(group)
    G, idx = len(ranks), mesh.get_local_rank(d)
    return G, idx, ranks[(idx - 1) % G], ranks[(idx + 1) % G]


def _shift(t: torch.Tensor, to: int, frm: int):
    """Start sending ``t`` to rank ``to`` and receiving its successor from
    rank ``frm``: (the receive buffer, the requests to wait on)."""
    buf = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, to),
                                   dist.P2POp(dist.irecv, buf, frm)])
    return buf, reqs


def _placed(mesh, axis: str, dim):
    """Placements sharding tensor dim ``dim`` over ``axis`` (``None``:
    replicated) and replicating over every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dim) if n == axis and dim is not None else Replicate()
                 for n in mesh.mesh_dim_names)


def allgather_matmul(x, w, mesh, axis: str = "model"):
    """y = all_gather(x, axis) @ w, ring-overlapped.

    x: (m, k) sharded on dim 0 over ``axis``; w: (k, n) replicated.
    Returns y = x_full @ w, replicated (all-gather semantics: every rank
    ends with every row's output)."""
    from torch.distributed.tensor import DTensor
    x_blk = to_placements(x, mesh, _placed(mesh, axis, 0)).to_local().contiguous()
    w_full = to_placements(w, mesh, _placed(mesh, axis, None)).to_local()
    G, idx, to, frm = _ring(mesh, axis)
    m_l, n = x_blk.shape[0], w_full.shape[1]
    out = x_blk.new_empty((G, m_l, n))
    blk = x_blk
    for i in range(G):
        src = (idx + i) % G                   # global block id held now
        if i < G - 1:                         # the next block travels meanwhile
            nxt, reqs = _shift(blk, to, frm)
        out[src] = blk @ w_full
        if i < G - 1:
            for r in reqs:
                r.wait()
            blk = nxt
    return DTensor.from_local(out.reshape(G * m_l, n), mesh, _placed(mesh, axis, None),
                              run_check=False)


def reduce_scatter_matmul(x, w, mesh, axis: str = "model"):
    """y = reduce_scatter(x @ w): the contraction split over ``axis``.

    x: (m, k) sharded on dim 1 (k) over ``axis``; w: (k, n) sharded on
    dim 0 (k).  Each rank computes partial sums of one row chunk a step
    and passes its f32 accumulator upstream, so rank d ends with output
    rows [d·m/G, (d+1)·m/G) fully summed; the next chunk's product runs
    while the accumulator travels.  Returns y (m, n) sharded on dim 0."""
    from torch.distributed.tensor import DTensor
    x_blk = to_placements(x, mesh, _placed(mesh, axis, 1)).to_local()
    w_blk = to_placements(w, mesh, _placed(mesh, axis, 0)).to_local()
    G, idx, to, frm = _ring(mesh, axis)
    m_l = x_blk.shape[0] // G

    def partial(i):
        c = (idx + 1 + i) % G                 # row chunk summed at step i
        return (x_blk[c * m_l:(c + 1) * m_l] @ w_blk).float()

    acc = partial(0)
    for i in range(1, G):
        recv, reqs = _shift(acc, to, frm)     # hand the accumulator upstream
        part = partial(i)
        for r in reqs:
            r.wait()
        acc = recv + part
    return DTensor.from_local(acc.to(x_blk.dtype), mesh, _placed(mesh, axis, 0),
                              run_check=False)


# -- oracles for tests ---------------------------------------------------------

def allgather_matmul_ref(x, w):
    return x @ w


def reduce_scatter_matmul_ref(x, w):
    return x @ w
