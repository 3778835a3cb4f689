"""Collective helpers on a `DeviceMesh` (port of
`repro.distributed.collectives`).

`hierarchical_psum` reduces in two hops on a multi-pod mesh:
reduce-scatter within the intra axis (the fast links), all-reduce of the
scattered shards across the inter axis (the slow links), all-gather
within the intra axis. Inter-axis traffic is 1/intra of a flat
all-reduce. `ring_all_gather` is the explicit ring of point-to-point
hops, one a step, that a hand-scheduled overlap would interleave with
compute.

Each rank calls them with its own tensor, as the reference's bodies run
inside `shard_map`; the mesh's groups (`DeviceMesh.get_group`) carry the
collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(mesh, axis: str):
    g = mesh.get_group(axis)
    return g, dist.get_world_size(g)


def hierarchical_psum(x: torch.Tensor, mesh, intra: str = "data",
                      inter: str = "pod") -> torch.Tensor:
    """The sum of ``x`` over the ``intra`` and ``inter`` axes, in two hops:
    reduce-scatter within ``intra`` along the first dim that the intra
    size divides, all-reduce across ``inter``, all-gather within
    ``intra``. A tensor with no such dim takes a flat all-reduce over
    both groups. Returns a new tensor; ``x`` is not changed."""
    g_intra, n_intra = _group(mesh, intra)
    g_inter, _ = _group(mesh, inter)
    dim = next((i for i, s in enumerate(x.shape) if s % n_intra == 0), None)
    if dim is None:
        out = x.clone()
        dist.all_reduce(out, group=g_intra)
        dist.all_reduce(out, group=g_inter)
        return out
    front = x.movedim(dim, 0).contiguous()
    part = front.new_empty((front.shape[0] // n_intra, *front.shape[1:]))
    dist.reduce_scatter_tensor(part, front, group=g_intra)
    dist.all_reduce(part, group=g_inter)
    full = torch.empty_like(front)
    dist.all_gather_into_tensor(full, part, group=g_intra)
    return full.movedim(0, dim).contiguous()


def ring_all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on dim 0 in the
    axis's rank order (stacked for a 0-d ``x``), gathered by n - 1 ring
    hops: each rank sends what it last received to the next rank and
    receives from the previous one (`batch_isend_irecv`)."""
    g, n = _group(mesh, axis)
    r = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(g, (r + 1) % n)
    prv = dist.get_global_rank(g, (r - 1) % n)
    cur = x.contiguous()
    pieces = [cur]                      # pieces[j] is rank (r - j)'s x
    for _ in range(n - 1):
        got = torch.empty_like(cur)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur, nxt, group=g),
            dist.P2POp(dist.irecv, got, prv, group=g)])
        for req in reqs:
            req.wait()
        pieces.append(got)
        cur = got
    canonical = [pieces[(r - i) % n] for i in range(n)]
    return torch.cat(canonical) if x.dim() else torch.stack(canonical)
