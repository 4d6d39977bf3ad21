"""GPipe-style pipeline parallelism over a ``stage`` mesh axis, the JAX
package's ``repro/distributed/pipeline.py`` over ``torch.distributed``.

Schedule: classic GPipe.  M microbatches flow through S stages; step t
(0 <= t < M + S - 1) runs stage s on microbatch t - s.  Activations move
stage s -> s+1 once a step (the reference's forward ``ppermute`` by one
along the stage axis: here a ``batch_isend_irecv`` over the stage axis's
group, ``shardmap_compat.ppermute``).  Each rank holds only its stage's
layer stack; bubbles are the usual (S-1)/(M+S-1) fraction.  The last
stage's outputs reach every stage through a masked psum, as in the
reference.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import shardmap_compat as smc
from repro_torch.distributed.shardmap_compat import P


def pipeline_apply(layer_fn: Callable, params_stacked, x_microbatches, *,
                   mesh, stage_axis: str = "stage"):
    """Run a GPipe forward pass.

    layer_fn(stage_params, x) -> x        (applied once per stage)
    params_stacked: a tree with leading dim = n_stages (stage-sharded: a
        DTensor split over ``stage_axis``, or the global tensor every rank
        holds, of which each keeps its stage's slice).
    x_microbatches: (M, mb, ...) microbatched input, the same on every
        rank.
    Returns (M, mb, ...) outputs, replicated over the stage axis (a
    DTensor).
    """
    n_stages = mesh.shape[stage_axis]

    def stage_prog(params, xs):
        sp = params[0] if isinstance(params, torch.Tensor) else \
            {k: v[0] for k, v in params.items()}
        sid = smc.axis_index(stage_axis)
        M = xs.shape[0]
        buf = torch.zeros_like(xs[0])             # current activation
        outs = torch.zeros_like(xs)
        fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        for t in range(M + n_stages - 1):
            # stage 0 ingests microbatch t (if in range)
            if sid == 0:
                buf = xs[min(t, M - 1)] if t < M else torch.zeros_like(buf)
            # every stage processes what it holds
            y = layer_fn(sp, buf)
            # the last stage emits microbatch t - (S-1) (if in range)
            emit = t - (n_stages - 1)
            if sid == n_stages - 1 and emit >= 0:
                outs = outs.index_copy(0, torch.tensor([emit],
                                                       device=outs.device),
                                       y[None])
            # shift activations forward one stage
            buf = smc.ppermute(y, stage_axis, fwd)
        # replicate the results to all stages (only the last stage holds
        # them; the masked psum acts as a broadcast)
        if sid != n_stages - 1:
            outs = torch.zeros_like(outs)
        return smc.psum(outs, stage_axis)

    return smc.shard_map(stage_prog, mesh=mesh,
                         in_specs=(P(stage_axis), P()),
                         out_specs=P())(params_stacked, x_microbatches)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1) / (M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
