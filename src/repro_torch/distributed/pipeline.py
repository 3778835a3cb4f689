"""GPipe-style pipeline parallelism over one mesh axis (port of
`repro.distributed.pipeline`).

Each rank of ``axis`` holds one contiguous stage; microbatches flow from
stage to stage by point-to-point sends. The schedule is the GPipe
fill/steady/drain loop: T = M + S - 1 steps for M microbatches over S
stages, bubble fraction (S - 1) / T.

`pipeline_forward` is forward-only with uniform stages, like the
reference's: it carries the communication pattern a trainer would use.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _local_stage(leaf: torch.Tensor, sid: int) -> torch.Tensor:
    """This stage's slice of a leaf stacked on a leading stage dim: a
    DTensor sharded over the stage axis holds only it; a plain tensor
    holds every stage."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[sid]


def pipeline_forward(mesh, stage_fn, stage_params: dict,
                     microbatches: torch.Tensor,
                     axis: str = "pod") -> torch.Tensor:
    """Run ``microbatches`` (M, ...) through the S stages laid over
    ``axis``; every rank returns the (M, ...) outputs of stage S - 1.

    ``stage_params``: a dict of tensors with a leading stage dim S (each
    rank reads its own slice), or of DTensors sharded on that dim over
    ``axis``. ``stage_fn(params, x)`` keeps x's shape. At step t stage 0
    takes microbatch t (while t < M), every stage applies its layers and
    sends the result to the next rank of the ring; a microbatch leaving
    stage S - 1 is broadcast to every stage, as the reference's psum
    makes it visible."""
    g = mesh.get_group(axis)
    n = dist.get_world_size(g)
    sid = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(g, (sid + 1) % n)
    prv = dist.get_global_rank(g, (sid - 1) % n)
    last = dist.get_global_rank(g, n - 1)
    params = {k: _local_stage(v, sid) for k, v in stage_params.items()}
    m = microbatches.shape[0]
    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(m + n - 1):
        x = microbatches[t] if sid == 0 and t < m else buf
        y = stage_fn(params, x).contiguous()
        if n > 1:
            buf = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group=g),
                dist.P2POp(dist.irecv, buf, prv, group=g)])
            for req in reqs:
                req.wait()
        else:
            buf = y
        out_idx = t - (n - 1)
        if out_idx >= 0:
            done = y.clone() if sid == n - 1 else torch.empty_like(y)
            dist.broadcast(done, src=last, group=g)
            outs[out_idx] = done
    return outs


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
