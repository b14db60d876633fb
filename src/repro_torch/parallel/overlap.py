"""Dual micro-batch overlap (paper §2.3.1) — port of
``repro.parallel.overlap`` to explicit SPMD on ``torch.distributed``.

The paper decouples MLA/MoE compute from the MoE dispatch and combine
all-to-alls: while micro-batch A computes, micro-batch B's all-to-all is
in flight, and the other way round. The reference only expresses the
dependency structure (both halves' ops in one scanned layer step) and
leaves the overlap to XLA's latency-hiding scheduler. Eager PyTorch runs
ops in program order, so the port writes the schedule itself.

Each layer of each half is a phase generator (``transformer.
block_phases``, or a dense/MoE pair of them: ``api.step_phases``;
``collectives.drive``): it yields each time it has issued an EP
collective it will wait for after resuming. :func:`_layer` runs the
two halves' generators of one layer in turns, and both halves' phases of
a layer come before the next layer's. On a mesh with EP the order is

* A's attention and gate, A's dispatch issued;
* B's attention and gate, B's dispatch issued;
* A's dispatch waited, A's experts, A's combine issued;
* B's dispatch waited, B's experts, B's combine issued;
* A's combine waited, A's token slices' gather issued; the same for B;
* A's gather waited and its shared expert; then B's,

so each half's all-to-all (and the combine's gather; ``ep_dedup``'s hop-2
exchanges, one step each) is in flight while the other half's kernels are
queued and run. What does not overlap: the tensor-parallel all-reduces
inside attention and the shared expert, the embedding's sum and the
logits' gather over the model group, which the reference's GSPMD also
leaves in each half's chain; they are issued and waited at once.
Unmeshed (or with ``moe_impl="local"``) nothing yields, and a layer runs
A's block, then B's.

``collectives.record()`` shows the schedule: every collective with the
layer and half that issued it (``collectives.tagged``), and each block's
``"attention"`` mark. It is the port's counterpart of the reference's
HLO helpers (``lowered_text``, ``while_body_op_counts``,
``collective_bytes``), which count the all-to-alls of one lowered scan
body; it counts the calls themselves.

``dual_loss_and_metrics`` is the training-step body: two anti-phase
microbatches layer by layer, the valid-token-weighted CE (+MTP) and
microbatch-averaged MoE metrics (``Model.loss_dual``).
``dual_microbatch_loss`` is the loss-only wrapper. ``dual_decode_step``
is the serving side (``Model.decode_loop(overlap=True)``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.api import remat, stack_stats, step_phases
from repro_torch.models.param import layer
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx_mod
from repro_torch.parallel import sharding


def _layer(phasesA, phasesB, name: str):
    """Run two halves' phase generators of one layer in turns, each step
    tagged with the layer and its half; a half that finishes first leaves
    the other to run alone. Returns (A's value, B's value)."""
    gens = {"A": phasesA, "B": phasesB}
    out: Dict[str, Any] = {}
    while gens:
        for half in list(gens):
            with coll.tagged(name, half):
                try:
                    next(gens[half])
                except StopIteration as stop:
                    out[half] = stop.value
                    del gens[half]
    return out["A"], out["B"]


def _dual_segments(model, params, xA, xB, ctxA: dict, ctxB: dict,
                   cacheA: Optional[dict] = None,
                   cacheB: Optional[dict] = None):
    """Every segment's layers over both halves, layer by layer
    (:func:`_layer`), each layer's pair of steps under the ctx's remat
    policy (``models/api.remat``, the single backbone's wrapper). Returns
    ``(hA, hB, statsA, statsB)``."""
    cfg = model.cfg
    statsA: Dict[str, dict] = {}
    statsB: Dict[str, dict] = {}
    policy = pctx_mod.get().remat
    for seg in model.segments:
        p = params[seg.name]
        cA = None if cacheA is None else cacheA.get(seg.name)
        cB = None if cacheB is None else cacheB.get(seg.name)
        sa, sb = [], []
        for i in range(seg.n):
            name = f"{seg.name}/{i}"

            def step(hA, hB, pl, lA, lB, seg=seg, name=name):
                return _layer(step_phases(seg, pl, hA, cfg, ctxA, lA),
                              step_phases(seg, pl, hB, cfg, ctxB, lB), name)

            (xA, _, stA), (xB, _, stB) = remat(step, policy)(
                xA, xB, sharding.gathered(p, (seg.name,), i),
                None if cA is None else layer(cA, i),
                None if cB is None else layer(cB, i))
            sa.append(stA)
            sb.append(stB)
        st = stack_stats(sa)
        if st:
            statsA[seg.name], statsB[seg.name] = st, stack_stats(sb)
    return xA, xB, statsA, statsB


def dual_backbone(model, params, tokensA, tokensB, ctxA: dict, ctxB: dict):
    """Two microbatches through the segment stacks, each layer applied to
    both before the next, so each half's MoE collectives are in flight
    under the other's compute. Returns ``(hA, hB, statsA, statsB)``: the
    stats per segment, stacked over its layers as the single backbone's
    (``load`` (n, E)), so the dual loss reports them identically."""
    xA = model._embed(params, tokensA)
    xB = model._embed(params, tokensB)
    return _dual_segments(model, params, xA, xB, ctxA, ctxB)


def _mkctx(tokens: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=tokens.device).expand(B, S)
    return dict(positions=pos, stats=True), pos


def dual_loss_and_metrics(model, params, batchA: Dict, batchB: Dict
                          ) -> Tuple[torch.Tensor, Dict]:
    """Loss and metrics over two anti-phase microbatches (the reference's,
    term for term).

    The CE term equals ``Model.loss``'s on the joined batch (the halves'
    means weighted by their valid-token counts, robust to uneven pads).
    The MTP term reuses the CE token fractions as weights: exact when the
    halves' MTP-valid proportions match their CE-valid ones (always for
    unpadded batches; an approximation under uneven padding). MoE metrics
    are microbatch-averaged. Differentiable, as ``Model.loss``: under a
    mesh the halves' EP collectives are issued as in the decode (each in
    flight under the other half's work) and their backward all-to-alls
    run in autograd's order; each half is this data rank's part of the
    global half, its counts and means global as ``Model.loss``'s."""
    dev = model.device
    tokA = torch.as_tensor(batchA["tokens"], device=dev)
    tokB = torch.as_tensor(batchB["tokens"], device=dev)
    ctxA, posA = _mkctx(tokA)
    ctxB, posB = _mkctx(tokB)
    # the sequence cut of ``Model.loss`` (``context.seq_group``)
    seq = pctx_mod.seq_divides(pctx_mod.get(), tokA.shape[1])
    with pctx_mod.sequence_sharded(seq):
        hA, hB, stA, stB = dual_backbone(model, params, tokA, tokB, ctxA,
                                         ctxB)
        sA, nA = model._ce_sum(params, hA, torch.as_tensor(
            batchA["labels"], device=dev))
        sB, nB = model._ce_sum(params, hB, torch.as_tensor(
            batchB["labels"], device=dev))
    ntokA = model.data_total(nA).clamp_min(1)
    ntokB = model.data_total(nB).clamp_min(1)
    lossA, lossB = sA / ntokA, sB / ntokB
    # valid-token-weighted: Model.loss's global mean even when pad labels
    # leave the halves unequal (0.5 / 0.5 for balanced halves)
    wA = ntokA / (ntokA + ntokB)
    wB = 1.0 - wA
    loss = wA * lossA + wB * lossB
    metrics: Dict[str, Any] = {"ce": model.data_sum(loss.detach()),
                               "ntokens": ntokA + ntokB}
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for segname in stA:
        a, b = stA[segname], stB[segname]
        aux = aux + 0.5 * (a["aux_loss"].mean() + b["aux_loss"].mean())
        metrics[f"{segname}/drop_frac"] = 0.5 * (a["drop"].mean()
                                                 + b["drop"].mean())
        metrics[f"{segname}/load_layers"] = 0.5 * (a["load"] + b["load"])
    metrics["aux_loss"] = aux
    if model.cfg.mtp:
        with pctx_mod.sequence_sharded(seq):
            mtp_l = (wA * model._mtp_loss(params, hA, tokA, posA, ctxA)
                     + wB * model._mtp_loss(params, hB, tokB, posB, ctxB))
        metrics["mtp_loss"] = model.data_sum(mtp_l.detach())
        loss = loss + mtp_l
    return model.data_sum(loss), metrics


def dual_microbatch_loss(model, params, batchA: Dict, batchB: Dict):
    """The dual loss alone (:func:`dual_loss_and_metrics`)."""
    return dual_loss_and_metrics(model, params, batchA, batchB)[0]


def cache_halves(model, cache: dict) -> Tuple[dict, dict]:
    """A dense decode cache's two halves along each leaf's batch axis
    (``Model._dense_cache_axes``): views of slots ``[0, b)`` and ``[b,
    2b)``, so a step written into a half writes the cache in place."""
    axes = model._dense_cache_axes(cache)

    def batch(tree, ax):
        if isinstance(tree, dict):
            k = next(iter(tree))
            return batch(tree[k], ax[k])
        return tree.shape[ax]

    b = batch(cache, axes) // 2

    def split(tree, ax, i):
        if isinstance(tree, dict):
            return {k: split(v, ax[k], i) for k, v in tree.items()}
        return tree.narrow(ax, i * b, b)

    return split(cache, axes, 0), split(cache, axes, 1)


def dual_decode_step(model, params, cacheA: dict, cacheB: dict, tokA, tokB,
                     posA, posB, batch_sharded: bool = False):
    """One decode step of two half-batches, layer by layer (module
    docstring): the serving side of :func:`dual_backbone`.

    tokA/tokB, posA/posB: (b, 1) int32. The caches are the halves' views
    of one dense decode cache (``Model._dense_cache_axes``), written in
    place as ``Model.decode_step`` writes them. ``batch_sharded``: as
    ``decode_step``'s. Returns ``(logitsA, logitsB, cacheA, cacheB)``.
    The MTP hidden is copied into each half's ``mtp_h`` as the single
    step does (the draft itself is refused under overlap). Dense caches
    only: a paged pool has no batch axis to split."""
    ctxA = model._ctx(params, positions=posA, batch_sharded=batch_sharded)
    ctxB = model._ctx(params, positions=posB, batch_sharded=batch_sharded)
    xA = model._embed(params, tokA)
    xB = model._embed(params, tokB)
    xA, xB, _, _ = _dual_segments(model, params, xA, xB, ctxA, ctxB,
                                  cacheA, cacheB)
    if "mtp_h" in cacheA:
        cacheA["mtp_h"].copy_(xA)
        cacheB["mtp_h"].copy_(xB)
    return (model._unembed(params, xA), model._unembed(params, xB),
            cacheA, cacheB)
