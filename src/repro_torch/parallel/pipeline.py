"""Pipeline parallelism (paper §4.2, T8) — port of
``repro.parallel.pipeline``: an executable pipelined forward over a
``pipe`` mesh axis, and the DualPipe schedule model.

Executable pipeline
-------------------
``pipeline_forward`` runs a stage function over microbatches, one stage a
rank of the ``pipe`` axis, on the reference's schedule of M + P - 1
ticks: at tick t stage s works on microbatch t - s. Activations move one
stage on at each tick by a point-to-point exchange
(``collectives.exchange``). It is one autograd function on every stage:
its backward runs the ticks in reverse, recomputing each active tick's
stage from its saved input and sending each input's gradient one stage
back, an exchange a tick on every stage alike (per-tick autograd nodes
would be pruned where a stage's tick does not reach its parameters, and
the stages' exchanges would no longer pair). The last stage's outputs are
gathered over the axis and every rank returns them (the reference's
``out_specs=P()``); the backward takes the last stage's gradient of them
(the consumer is replicated).

DualPipe schedule model
-----------------------
The schedule mathematics (bubble fraction, 1F/1B/1W timing — the
quantities in the paper's Table 4), copied:

  1F1B bubble fraction      = (P-1) / (M + P - 1)
  DualPipe: see ``dualpipe_bubble``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.parallel import collectives as coll


def _pass_on(t: torch.Tensor, group, s: int, n: int, back: bool
             ) -> torch.Tensor:
    """One tick's exchange on the stage ring: forward each stage sends to
    s + 1 and receives from s - 1 (stage 0 gets zeros); backward each
    sends to s - 1 and receives from s + 1 (the last stage gets zeros)."""
    to, frm = ((s - 1) % n, (s + 1) % n) if back else ((s + 1) % n,
                                                        (s - 1) % n)
    got, = coll.exchange([t.contiguous()], group, to, frm)
    edge = n - 1 if back else 0
    return torch.zeros_like(got) if s == edge else got


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, spec, group, s, n, x_mb, *leaves):
        p = tree_unflatten(list(leaves), spec)
        M = x_mb.shape[0]
        ticks = M + n - 1
        inflight = torch.zeros_like(x_mb[0])
        ins, outs = {}, []
        for t in range(ticks):
            x_in = x_mb[min(t, M - 1)] if s == 0 else inflight
            if 0 <= t - s < M:
                ins[t] = x_in
                y = stage_fn(p, x_in)
                if s == n - 1:
                    outs.append(y)
            else:
                y = inflight
            if t < ticks - 1:
                inflight = _pass_on(y, group, s, n, back=False)
        out = (torch.stack(outs) if s == n - 1 else
               torch.zeros((M,) + tuple(x_mb.shape[1:]), dtype=x_mb.dtype,
                           device=x_mb.device))
        ctx.stage_fn, ctx.spec, ctx.group, ctx.s, ctx.n = (
            stage_fn, spec, group, s, n)
        ctx.ins, ctx.M = ins, M
        ctx.save_for_backward(x_mb, *leaves)
        return coll.all_gather(out[None], group)[n - 1]

    @staticmethod
    def backward(ctx, g_out):
        x_mb, *leaves = ctx.saved_tensors
        s, n, M, group = ctx.s, ctx.n, ctx.M, ctx.group
        ticks = M + n - 1
        gl = [torch.zeros_like(l) for l in leaves]
        gx = torch.zeros_like(x_mb)
        g_y = torch.zeros_like(x_mb[0])     # gradient of this tick's y
        with coll.tagged(phase="bwd"):
            for t in reversed(range(ticks)):
                if s == n - 1 and 0 <= t - (n - 1) < M:
                    g_y = g_y + g_out[t - (n - 1)]
                if 0 <= t - s < M:
                    with torch.enable_grad():
                        lv = [l.detach().requires_grad_(True)
                              for l in leaves]
                        xi = ctx.ins[t].detach().requires_grad_(True)
                        y = ctx.stage_fn(tree_unflatten(lv, ctx.spec), xi)
                        got = torch.autograd.grad(y, lv + [xi], g_y,
                                                  allow_unused=True)
                    for i, g in enumerate(got[:-1]):
                        if g is not None:
                            gl[i] += g
                    g_in = got[-1]
                    if s == 0:
                        gx[t] += g_in
                        g_in = torch.zeros_like(g_in)
                else:
                    g_in = g_y                       # y was the inflight
                if t > 0:
                    g_y = _pass_on(g_in, group, s, n, back=True)
        if ctx.needs_input_grad[5]:
            gx = coll.all_reduce(gx, group)          # x_mb is replicated
        return (None, None, None, None, None, gx) + tuple(gl)


def pipeline_forward(stage_fn: Callable, params_stages, x_mb: torch.Tensor,
                     mesh, axis: str = "pipe") -> torch.Tensor:
    """Run P pipeline stages over M microbatches.

    stage_fn(stage_params, x) -> y, applied by every rank to its stage.
    params_stages: this rank's stage parameters (a tensor or a tree of
    tensors; the reference's leading stage dim, cut over ``axis``, is
    gone). x_mb: (M, mb, ...) microbatches, the same on every rank.
    Returns (M, mb, ...) outputs of the LAST stage, on every rank.

    Schedule: M + P - 1 ticks; at tick t stage s works on microbatch
    t - s when it is in range (stage 0 reads it fresh, the others take
    what the stage before sent at the previous tick)."""
    leaves, spec = tree_flatten(params_stages)
    return _Pipeline.apply(stage_fn, spec, mesh.groups[axis],
                           mesh.coords[axis], mesh.shape[axis], x_mb,
                           *leaves)


# ---------------------------------------------------------------------------
# Schedule mathematics (paper Table 4 quantities)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduleStats:
    name: str
    ticks: float          # total slots in units of one microbatch fwd+bwd
    bubble_frac: float
    comm_overlapped: bool


def onef1b_bubble(P: int, M: int, f: float = 1.0, b: float = 2.0,
                  w: float = 0.0) -> ScheduleStats:
    """Classic 1F1B: bubble = (P-1)(f+b) over M(f+b) + (P-1)(f+b)."""
    total = M * (f + b + w) + (P - 1) * (f + b + w)
    bubble = (P - 1) * (f + b + w)
    return ScheduleStats("1F1B", total, bubble / total, False)


def dualpipe_bubble(P: int, M: int, f: float = 1.0, b: float = 2.0,
                    w: float = 0.0) -> ScheduleStats:
    """DualPipe (paper [29]): bidirectional injection halves the pipeline
    depth seen by each direction and the W (weight-grad) slots fill the
    remaining bubble: bubble ≈ (P/2 - 1)(f + b - 2w) per direction over the
    same span, with dispatch/combine fully overlapped."""
    total = M * (f + b + w) + (P / 2 - 1) * (f + b)
    bubble = max(P / 2 - 1, 0) * max(f + b - 2 * w, 0)
    return ScheduleStats("DualPipe", total, bubble / total, True)
