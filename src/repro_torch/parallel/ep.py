"""Expert-parallel MoE dispatch/combine (paper §4.2–4.3) — port of
``repro.parallel.ep`` from ``shard_map`` to explicit SPMD: every rank runs
the body for its own model column and the all-to-alls are
``torch.distributed`` calls over the rank's model-axis group
(``parallel/collectives``; staged through pinned host memory under gloo).

Two wire protocols, equivalence-tested against the local MoE:

* ``ep_flat``  — plain EP: every (token, expert) routed straight to the
  expert's model-axis column.
* ``ep_dedup`` — the paper's node-limited two-hop protocol. Expert groups
  ("nodes") map to contiguous spans of ``cpg = cols / G`` columns. Each
  token is sent once per selected group (≤ ``group_limit``), chunk-split
  across the group's columns inside the one all-to-all; hop 2 is an
  intra-group point-to-point exchange; combine runs in reverse with an
  intra-group partial sum first. As in the reference, a mesh whose column
  count the groups do not divide silently runs ``ep_flat``.

Wire precision (paper §3.1/§2.3.2): dispatch payloads travel as E4M3 bytes
with fp32 1x128-tile scales (``wire="fp8"``), or bf16/fp32 with unit
scales; combine returns bf16 (fp32 at the fp32 wire). The payload, its
scales and its routing metadata cross in one all-to-all, packed as bytes
(the same bytes as the reference's four).

Token layout: each data row's tokens (or, ``replicated``, every token on
every data row) are split over the row's model columns; the shared expert
runs outside the dispatch, tensor-parallel over ``mlp``. Token counts that
don't divide are padded and masked into the overflow bucket (no capacity,
no wire). ``ep_ftp`` (decode): tokens replicated over the data axes
(gathered over them, or over the pair ``("pod", "data")``, when each
data row holds its own), each expert's FF dimension split over
``"data"``, partial outputs summed over ``"data"`` alone (:func:`ftp_group`:
on a pod mesh the experts replicate over ``"pod"``, so a sum over the
pair would count each partial |pod| times, as the reference's does); with
FP8 experts each rank quantizes its own slice, which must be whole
128-blocks. Under a sequence cut (``context.seq_group``, training) each
column dispatches its own chunk of tokens.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fp8
from repro_torch.core import moe as moe_mod
from repro_torch.core import routing
from repro_torch.device import torch_dtype
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx_mod
from repro_torch.parallel.context import ParallelCtx

_WIRE_BYTES = {"fp8": 1, "bf16": 2, "fp32": 4}


# ---------------------------------------------------------------------------
# wire codecs (paper: FP8 dispatch, BF16 combine)
# ---------------------------------------------------------------------------


def _wire_encode(x: torch.Tensor, wire: str = "fp8"):
    """FP8 wire: (uint8 payload, fp32 1x128-tile scales). Other modes keep a
    unit scale sideband so the protocol shape is wire-independent."""
    if wire == "fp8":
        q, s = fp8.quantize_tilewise(x.float())
        return q.view(torch.uint8), s
    dt = torch.bfloat16 if wire == "bf16" else torch.float32
    s = torch.ones(x.shape[:-1] + (max(1, -(-x.shape[-1] // fp8.TILE)),),
                   dtype=torch.float32, device=x.device)
    return x.to(dt), s


def _wire_decode(q: torch.Tensor, s: torch.Tensor, dtype, wire: str = "fp8"):
    if wire == "fp8":
        return fp8.dequant_tilewise(q.view(fp8.E4M3), s).to(dtype)
    return q.to(dtype)


def _scatter_rows(n_slots: int, dest: torch.Tensor, keep: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """rows: (t, k, d) or (t*k, d) added into (n_slots, d) at ``dest``
    (dropped rows land in a trash row past the end)."""
    d = rows.shape[-1]
    rows2 = rows.reshape(-1, d)
    out = torch.zeros((n_slots + 1, d), dtype=rows.dtype, device=rows.device)
    out.index_add_(0, torch.where(keep, dest, n_slots), rows2)
    return out[:n_slots]


def _scatter_set(n_slots: int, dest: torch.Tensor, keep: torch.Tensor,
                 vals: torch.Tensor, fill) -> torch.Tensor:
    """``fill``-initialized (n_slots, ...) with the kept ``vals`` set at
    ``dest`` (kept destinations are distinct)."""
    out = torch.full((n_slots + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=vals.device)
    out[torch.where(keep, dest, n_slots)] = vals
    return out[:n_slots]


def _slice_tokens(x, mask, cols: int, j: int):
    per = x.shape[0] // cols
    return x[j * per:(j + 1) * per], mask[j * per:(j + 1) * per]


def _unslice_tokens(y: torch.Tensor, group):
    """Phases: the model group's token slices gathered back (one all-gather
    in flight). The consumer is replicated over the group, so the
    backward takes this column's slice of the gradient."""
    if group is None:
        return y
    pend = coll.all_gather_start(y.detach(), group)
    yield
    return coll.waited(pend, [y],
                       lambda g: [coll.own_part(g[0], group, 0)])


def _pack(parts: Sequence[torch.Tensor]):
    """Several ``(cols, c, ...)`` buffers as one ``(cols, c, bytes)``
    uint8 buffer, row by row; returns it and each part's byte width."""
    cols, c = parts[0].shape[:2]
    views = [p.detach().contiguous().reshape(-1).view(torch.uint8).reshape(
        cols, c, -1) for p in parts]
    return torch.cat(views, dim=-1), [v.shape[-1] for v in views]


def _unpack(buf: torch.Tensor, likes: Sequence[torch.Tensor], widths):
    got, o = [], 0
    for p, w in zip(likes, widths):
        got.append(buf[..., o:o + w].contiguous().reshape(-1).view(p.dtype)
                   .reshape(p.shape))
        o += w
    return got


def _carries(parts: Sequence[torch.Tensor]) -> List[bool]:
    """Which parts carry a gradient across a collective (the same on every
    rank: it follows the program, not the data)."""
    return [p.is_floating_point() and p.requires_grad for p in parts]


def _a2a(group, parts: Sequence[torch.Tensor]):
    """Phases: one tiled all-to-all of several ``(cols, c, ...)`` buffers,
    packed row by row as bytes, in flight across one yield; returns the
    received buffers, shapes and dtypes kept. Under autograd the parts
    that carry a gradient (floating and requiring one: the payload at the
    bf16/fp32 wire, the FP8 wire's scales, the routing weights, the
    combine's rows; never the E4M3 codes, moved as bytes) go back in the
    backward's one reverse all-to-all, packed the same way."""
    if group is None:
        return list(parts)
    buf, widths = _pack(parts)
    pend = coll.all_to_all_start(buf, group)
    yield
    keep = _carries(parts)

    def bwd(gs):
        gs = [torch.zeros_like(p) if g is None else g.to(p.dtype)
              for g, p, k in zip(gs, parts, keep) if k]
        gbuf, gw = _pack(gs)
        back = iter(_unpack(coll.all_to_all(gbuf, group), gs, gw))
        return [next(back) if k else None for k in keep]

    return coll.waited(pend, list(parts), bwd, keep,
                       finish=lambda out: _unpack(out, parts, widths))


# ---------------------------------------------------------------------------
# intra-group exchange primitives (the "NVLink domain" of the paper)
# ---------------------------------------------------------------------------


def _exchange(parts: Sequence[torch.Tensor], group, nxt: int, prv: int):
    """Phases: one intra-group exchange (send ``parts`` to group member
    ``nxt``, receive the same shapes from ``prv``) in flight across one
    yield. Its backward sends the received parts' gradients back to
    ``prv`` and takes those of the sent ones from ``nxt``."""
    pend = coll.exchange_start([p.detach().contiguous() for p in parts],
                               group, nxt, prv)
    yield
    keep = _carries(parts)

    def bwd(gs):
        send = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                for g, p, k in zip(gs, parts, keep) if k]
        back = iter(coll.exchange(send, group, prv, nxt))
        return [next(back) if k else None for k in keep]

    return coll.waited(pend, list(parts), bwd, keep)


def _group_allgather(zs: Sequence[torch.Tensor], group, j: int, cpg: int):
    """Phases. zs: this column's hop-1 chunks (owner rank = col % cpg).
    Returns, per chunk, (cpg, *z.shape) with index r = the chunk owned by
    group-rank r; each step's exchange carries every chunk, in flight
    across one yield."""
    base, rj = j // cpg * cpg, j % cpg
    received = [list(zs)]                            # rank rj
    for step in range(1, cpg):
        got = yield from _exchange(list(zs), group, base + (rj + step) % cpg,
                                   base + (rj - step) % cpg)
        received.append(got)                         # rank (rj - step) % cpg
    order = [(rj - r) % cpg for r in range(cpg)]
    return [torch.stack([r[i] for r in received])[order]
            for i in range(len(zs))]


def _group_reduce(parts: torch.Tensor, group, j: int, cpg: int):
    """Phases. parts: (cpg, ...) this column's partial outputs indexed by
    owner rank. Returns this column's own chunk summed over the group."""
    base, rj = j // cpg * cpg, j % cpg
    acc = parts[rj]
    for step in range(1, cpg):
        got, = yield from _exchange([parts[(rj + step) % cpg].contiguous()],
                                    group, base + (rj + step) % cpg,
                                    base + (rj - step) % cpg)
        acc = acc + got
    return acc


# ---------------------------------------------------------------------------
# flat EP
# ---------------------------------------------------------------------------


def _ep_flat_local(wg, bias, w1, w3, w2, x, mask, cfg: ModelConfig, group,
                   j: int, cols: int, wire: str = "fp8",
                   weights_qdq: bool = False, stats: bool = False,
                   split: bool = True):
    """Phases of flat EP (module docstring): routing and the dispatch
    issued | dispatch waited, the experts, the combine issued | combine
    waited, the token slices' gather issued | gathered. ``split`` False:
    ``x`` is this column's own tokens already (a sequence cut), neither
    sliced nor gathered back."""
    mc = cfg.moe
    E_l = mc.num_experts // cols
    xt, mt = _slice_tokens(x, mask, cols, j) if split else (x, mask)
    t, d = xt.shape
    k = mc.top_k

    rr = routing.route(xt, wg, mc, bias=bias, stats=stats)
    col_of = torch.where(mt[:, None], rr.expert_idx.long() // E_l, cols)
    Cc = moe_mod.capacity(t, mc, experts=cols)
    plan = moe_mod.dispatch_plan(col_of, cols + 1, Cc)
    n_slots = (cols + 1) * Cc

    send = _scatter_rows(n_slots, plan.dest, plan.keep,
                         xt[:, None].expand(t, k, d))
    ids = _scatter_set(n_slots, plan.dest, plan.keep,
                       (rr.expert_idx.long() % E_l).reshape(-1).int(), -1)
    wts = _scatter_set(n_slots, plan.dest, plan.keep,
                       rr.weights.reshape(-1).float(), 0.0)
    send = send.reshape(cols + 1, Cc, d)[:cols]
    ids = ids.reshape(cols + 1, Cc)[:cols]
    wts = wts.reshape(cols + 1, Cc)[:cols]

    # dispatch all-to-all (FP8 wire): payload, scales and metadata in one
    q, s = _wire_encode(send, wire)
    q, s, ids, wts = yield from _a2a(group, [q, s, ids, wts])
    recv = _wire_decode(q.reshape(cols * Cc, d), s.reshape(cols * Cc, -1),
                        torch_dtype(cfg.dtype), wire)
    ids = ids.reshape(-1).long()

    # local grouped GEMM over my experts (+1 overflow bucket)
    C2 = moe_mod.capacity(cols * Cc, mc, experts=E_l, k=1)
    plan2 = moe_mod.dispatch_plan(
        torch.where(ids >= 0, ids, E_l)[:, None], E_l + 1, C2)
    buf = _scatter_rows((E_l + 1) * C2, plan2.dest, plan2.keep, recv)
    h = moe_mod.expert_ffn(buf.reshape(E_l + 1, C2, d)[:E_l], w1, w3, w2,
                           cfg, weights_qdq)
    h = torch.cat([h, h.new_zeros((1, C2, d))], 0)
    y = h.reshape(-1, d)[plan2.dest] * plan2.keep[:, None]
    y = y * wts.reshape(-1, 1).to(y.dtype)

    # combine all-to-all (BF16 wire)
    cdt = torch.float32 if wire == "fp32" else torch.bfloat16
    y, = yield from _a2a(group, [y.reshape(cols, Cc, d).to(cdt)])
    y = y.reshape(cols * Cc, d).float()
    y = torch.cat([y, y.new_zeros((Cc, d))], 0)          # overflow rows
    back = y[plan.dest] * plan.keep[:, None]
    yt = back.reshape(t, k, d).sum(1).to(xt.dtype)
    if split:
        yt = yield from _unslice_tokens(yt, group)
    return yt, rr.load, plan.drop_frac, rr.aux_loss


# ---------------------------------------------------------------------------
# node-limited dedup EP (paper §4.3)
# ---------------------------------------------------------------------------


def _ep_dedup_local(wg, bias, w1, w3, w2, x, mask, cfg: ModelConfig, group,
                    j: int, cols: int, wire: str = "fp8",
                    weights_qdq: bool = False, stats: bool = False,
                    split: bool = True):
    """Phases of the two-hop protocol (module docstring), as
    :func:`_ep_flat_local`'s with hop 2's exchanges (each in flight across
    a yield) after the dispatch and before the combine."""
    mc = cfg.moe
    G = mc.num_groups
    assert cols % G == 0, (cols, G)
    cpg = cols // G
    E_l = mc.num_experts // cols
    epg = mc.num_experts // G
    xt, mt = _slice_tokens(x, mask, cols, j) if split else (x, mask)
    t, d = xt.shape
    k = mc.top_k

    rr = routing.route(xt, wg, mc, bias=bias, stats=stats)
    eidx = rr.expert_idx.long()
    grp = eidx // epg                                    # (t, k)

    # distinct groups per token (<= group_limit), padded with G
    sg = torch.sort(grp, dim=-1).values
    first = torch.cat([torch.ones((t, 1), dtype=torch.bool,
                                  device=x.device), sg[:, 1:] != sg[:, :-1]],
                      dim=1)
    marked = torch.where(first, sg, G)
    L = min(mc.group_limit, k, G)      # max distinct groups a token can hit
    dg = torch.sort(marked, dim=-1).values[:, :L]        # (t, L)
    dg = torch.where(mt[:, None], dg, G)

    Cg = moe_mod.capacity(t, mc, experts=G, k=L)
    Cg = -(-Cg // cpg) * cpg
    plan = moe_mod.dispatch_plan(dg, G + 1, Cg)
    n_slots = (G + 1) * Cg

    send = _scatter_rows(n_slots, plan.dest, plan.keep,
                         xt[:, None].expand(t, L, d))
    # per-slot metadata: the token's expert ids/weights within dest group
    tok_grp = grp.repeat_interleave(L, dim=0)            # (t*L, k)
    slot_grp = dg.reshape(-1)                            # (t*L,)
    in_grp = tok_grp == slot_grp[:, None]
    eids = torch.where(in_grp, (eidx % epg).repeat_interleave(L, dim=0), -1)
    ews = torch.where(in_grp, rr.weights.float().repeat_interleave(L, dim=0),
                      0.0)
    meta_e = _scatter_set(n_slots, plan.dest, plan.keep, eids.int(), -1)
    meta_w = _scatter_set(n_slots, plan.dest, plan.keep, ews, 0.0)
    send = send.reshape(G + 1, Cg, d)[:G]
    meta_e = meta_e.reshape(G + 1, Cg, k)[:G]
    meta_w = meta_w.reshape(G + 1, Cg, k)[:G]

    # hop 1: all-to-all, group buffers chunk-split over group columns
    Ck = Cg // cpg

    def chunks(z):
        return z.reshape((cols, Ck) + tuple(z.shape[2:]))

    q, s = _wire_encode(send, wire)
    q, s, me, mw = yield from _a2a(group, [chunks(q), chunks(s),
                                           chunks(meta_e), chunks(meta_w)])

    # hop 2: intra-group exchange -> every column holds the full group
    # buffer, (cpg, cols, Ck, ...) each
    gq, gs, gme, gmw = yield from _group_allgather([q, s, me, mw], group, j,
                                                   cpg)

    n_recv = cpg * cols * Ck
    recv = _wire_decode(gq.reshape(n_recv, d), gs.reshape(n_recv, -1),
                        torch_dtype(cfg.dtype), wire)
    ids_all = gme.reshape(n_recv, k).long()
    wts_all = gmw.reshape(n_recv, k)

    # my column's experts live at group-local ids [rj*E_l, (rj+1)*E_l)
    rj = j % cpg
    rel = ids_all - rj * E_l
    rel = torch.where((rel >= 0) & (rel < E_l), rel, E_l)
    C2 = moe_mod.capacity(n_recv, mc, experts=E_l, k=max(1, k // cpg))
    plan2 = moe_mod.dispatch_plan(rel, E_l + 1, C2)
    xk2 = recv[:, None].expand(n_recv, k, d)
    buf = _scatter_rows((E_l + 1) * C2, plan2.dest, plan2.keep, xk2)
    h = moe_mod.expert_ffn(buf.reshape(E_l + 1, C2, d)[:E_l], w1, w3, w2,
                           cfg, weights_qdq)
    h = torch.cat([h, h.new_zeros((1, C2, d))], 0)
    back = h.reshape(-1, d)[plan2.dest] * plan2.keep[:, None]
    back = back * wts_all.reshape(-1, 1).to(back.dtype)
    partial = back.reshape(n_recv, k, d).sum(1)
    partial = partial.reshape(cpg, cols, Ck, d)

    # combine hop 2: intra-group partial sums back to the chunk owner
    total = yield from _group_reduce(partial, group, j, cpg)  # (cols, Ck, d)

    # combine hop 1: reverse all-to-all (BF16 wire)
    cdt = torch.float32 if wire == "fp32" else torch.bfloat16
    y, = yield from _a2a(group, [total.to(cdt)])
    y = y.reshape(G, Cg, d).float()
    y = torch.cat([y, y.new_zeros((1, Cg, d))], 0)
    backh = y.reshape(-1, d)[plan.dest] * plan.keep[:, None]
    yt = backh.reshape(t, L, d).sum(1).to(xt.dtype)
    if split:
        yt = yield from _unslice_tokens(yt, group)
    return yt, rr.load, plan.drop_frac, rr.aux_loss


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def ftp_group(pctx: ParallelCtx):
    """The group ``ep_ftp`` sums the expert-FF partials over: the
    ``"data"`` line, the axis the expert FF is cut over
    (``sharding.tp_rules``' ``expert_ff``); None where it has one
    position."""
    return pctx.group("data")


def _check_ftp_blocks(p: dict, cfg: ModelConfig) -> None:
    """``ep_ftp`` with FP8 experts: each rank quantizes its slice of the
    expert FF dimension in 128-wide tiles and 128x128 blocks, as the
    reference's body does inside its ``shard_map``; a slice of whole
    128-blocks keeps the single device's blocks. Raise where the
    ``"data"`` axis cuts a block."""
    f, f_local = cfg.moe.expert_ff, p["w1"].shape[-1]
    if f_local != f and f_local % fp8.BLOCK:
        raise ValueError(
            f"ep_ftp with cfg.fp8: the data axis cuts the expert FF "
            f"dimension {f} into {f_local} a rank, not a multiple of "
            f"{fp8.BLOCK}: its FP8 tiles and blocks would cross the cut")


def uses_dedup(cfg: ModelConfig, pctx: ParallelCtx) -> bool:
    """``ep_dedup`` runs only where the groups divide the columns and the
    columns the experts; elsewhere the reference (and the port) run
    ``ep_flat`` without a word."""
    cols = pctx.mesh.shape[pctx.ep_axis]
    mc = cfg.moe
    return (pctx.moe_impl == "ep_dedup" and cols % mc.num_groups == 0
            and mc.num_experts % cols == 0)


def _pmean(v: torch.Tensor, groups) -> torch.Tensor:
    """The mean over each group in turn; a metric (the router's load, its
    aux loss, the drop fraction), so detached: no gradient."""
    v = v.detach()
    for g in groups:
        if g is not None:
            v = coll.all_reduce(v.float(), g) / dist.get_world_size(g)
    return v


def moe_ffn_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    pctx: ParallelCtx, valid: Optional[torch.Tensor] = None,
                    weights_qdq: bool = False, replicated: bool = False,
                    stats: bool = False):
    """:func:`moe_ffn_phases` run through, each collective waited for at
    once."""
    return coll.drive(moe_ffn_phases(p, x, cfg, pctx, valid, weights_qdq,
                                     replicated, stats))


def moe_ffn_phases(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   pctx: ParallelCtx, valid: Optional[torch.Tensor] = None,
                   weights_qdq: bool = False, replicated: bool = False,
                   stats: bool = False):
    """MoE layer over the mesh: this rank's part, as phases
    (``collectives.drive``): routing and the dispatch issued; the dispatch
    waited, the experts, the combine issued (``ep_dedup``: hop 2's
    exchanges between); the combine waited, the token slices' gather
    issued; gathered, the shared expert. Each yield leaves one collective
    in flight. x: (B, S, d), this data
    row's tokens (``replicated``: the same tokens on every data row, as a
    batch-1 prefill), the same on every model column; a data row is a
    position of the data axes (``ParallelCtx.dp_index``). Returns (y,
    RouteResult-like, drop_frac) for the same tokens.

    ``valid`` ((B, S) bool) marks real tokens: bucketed-prefill pads fold
    into the overflow bucket with the divisibility padding, so they take
    no capacity and no wire. The capacity of an EP shard follows from its
    padded token count; where nothing drops, results match the local
    path's dispatch token for token. ``stats``: the route's load, aux and
    drop, averaged over the model group and the data axes' (else None)."""
    mc = cfg.moe
    group = pctx.group(pctx.ep_axis)
    cols = pctx.mesh.shape[pctx.ep_axis]
    j = pctx.index(pctx.ep_axis)
    body = _ep_dedup_local if uses_dedup(cfg, pctx) else _ep_flat_local
    ftp = pctx.ep_ftp
    dgroup = pctx.dp_group
    fgroup = ftp_group(pctx) if ftp else None
    if fgroup is not None and cfg.fp8:
        _check_ftp_blocks(p, cfg)
    gather = ftp and not replicated and dgroup is not None
    # a sequence cut: this column's tokens are its own chunk already
    own = pctx_mod.seq_group() is not None

    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    v = None if valid is None else valid.reshape(-1).bool()
    if gather:
        # decode mode: tokens replicated over the data axes, the expert FF
        # split over "data"
        xt = coll.all_gather(xt, dgroup)
        if v is not None:
            v = coll.all_gather(v, dgroup)
    T = xt.shape[0]
    Tpad = T if own else -(-T // cols) * cols
    mask = torch.arange(Tpad, device=x.device) < T
    if v is not None:
        mask = mask & torch.nn.functional.pad(v, (0, Tpad - T))
    if Tpad != T:
        xt = torch.nn.functional.pad(xt, (0, 0, 0, Tpad - T))

    bias = p.get("bias")
    if bias is None:
        bias = torch.zeros((mc.num_experts,), dtype=torch.float32,
                           device=x.device)
    # each column routes and sends its own token slice: the replicated
    # tokens and router weight enter through copy_to_group (their
    # gradients are summed over the model group)
    if not own:
        xt = coll.copy_to_group(xt, group)
    wg = coll.copy_to_group(p["w_gate"], group)
    y, load, drop, aux = yield from body(
        wg, bias, p["w1"], p["w3"], p["w2"], xt, mask, cfg, group,
        j, cols, pctx.wire, weights_qdq, stats, split=not own)
    if fgroup is not None:
        y = coll.reduce_sum(y.float(), fgroup).to(y.dtype)   # FF partials
    y = y[:T]
    if gather:
        per = T // pctx.dp_size
        i = pctx.dp_index
        y = y[i * per:(i + 1) * per]
    if stats:
        groups = (group, dgroup)
        load, drop, aux = (_pmean(t, groups) for t in (load, drop, aux))
    y = y.reshape(shape) + moe_mod.shared_expert(p, x, cfg, weights_qdq)
    rr = routing.RouteResult(None, None, None, load, aux)
    return y, rr, drop


def alltoall_bytes(cfg: ModelConfig, pctx: ParallelCtx, tokens: int) -> int:
    """Bytes one rank's all-to-alls move in one MoE layer when its data
    row holds ``tokens`` tokens: the dispatch (payload, scales, expert ids
    and weights) and the combine buffers, whole, as the reference's
    ``collective_bytes`` reads them off its lowering. The sizes are the
    ones :func:`moe_ffn_sharded`'s bodies build."""
    mc = cfg.moe
    cols = pctx.mesh.shape[pctx.ep_axis]
    if pctx.ep_ftp:
        tokens *= pctx.dp_size
    t = -(-tokens // cols)
    d = cfg.d_model
    wire = _WIRE_BYTES[pctx.wire]
    combine = 4 if pctx.wire == "fp32" else 2
    tiles = max(1, -(-d // fp8.TILE))
    k = mc.top_k
    if uses_dedup(cfg, pctx):
        G = mc.num_groups
        cpg = cols // G
        L = min(mc.group_limit, k, G)
        Cg = moe_mod.capacity(t, mc, experts=G, k=L)
        rows = -(-Cg // cpg) * cpg // cpg * cols
        meta = 8 * k
    else:
        rows = cols * moe_mod.capacity(t, mc, experts=cols)
        meta = 8
    return rows * (d * wire + 4 * tiles + meta + d * combine)
