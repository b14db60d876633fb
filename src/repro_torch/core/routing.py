"""Node-limited TopK expert selection (paper §4.3, T3) with aux-loss-free
bias balancing (DeepSeek-V3) — port of ``repro.core.routing.route``.

  scores  = score_fn(x @ Wg)                  (sigmoid for V3, softmax
                                               for qwen3-moe)
  select  on scores + bias (selection only, never the mixture weights)
  group_score(g) = sum of top-``group_top`` biased scores in group g
  keep top-``group_limit`` groups, mask the rest, take top-k experts
  weights = scores of the selected experts, renormalized, x route_scale

Balancing diagnostics as the reference's: ``load`` (the fraction of
assignments per expert) and the switch-style ``aux_loss`` (diagnostic
only: DeepSeek-V3 is aux-loss-free; :func:`update_bias` balances).
``route(stats=False)`` skips them, where nothing reads them (serving: the
reference's jit drops them as dead code).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MoEConfig


class RouteResult(NamedTuple):
    expert_idx: torch.Tensor   # (..., k) int32
    weights: torch.Tensor      # (..., k) fp32
    scores: torch.Tensor       # (..., E) fp32 post-activation scores
    load: Optional[torch.Tensor] = None      # (E,) assignments per expert
    aux_loss: Optional[torch.Tensor] = None  # scalar switch-style aux loss


def route(x: torch.Tensor, w_gate: torch.Tensor, cfg: MoEConfig,
          bias: Optional[torch.Tensor] = None,
          stats: bool = True) -> RouteResult:
    """x: (..., d); w_gate: (d, E); bias: (E,) or None. ``stats``: also
    the balancing diagnostics ``load`` and ``aux_loss`` (no gradient)."""
    logits = torch.matmul(x.float(), w_gate.float())
    if cfg.score_fn == "sigmoid":
        scores = torch.sigmoid(logits)
    elif cfg.score_fn == "softmax":
        scores = torch.softmax(logits, dim=-1)
    else:
        raise ValueError(cfg.score_fn)

    sel = scores if bias is None else scores + bias.float()
    E, G = cfg.num_experts, cfg.num_groups
    epg = E // G

    if cfg.group_limit < G:
        # --- node-limited masking -----------------------------------------
        gsel = sel.reshape(*sel.shape[:-1], G, epg)
        top_in_group = gsel.topk(min(cfg.group_top, epg), dim=-1).values
        group_score = top_in_group.sum(-1)                  # (..., G)
        top_groups = group_score.topk(cfg.group_limit, dim=-1).indices
        gmask = torch.zeros_like(group_score, dtype=torch.bool)
        gmask.scatter_(-1, top_groups, True)
        emask = gmask.repeat_interleave(epg, dim=-1)
        sel = sel.masked_fill(~emask, float("-inf"))

    expert_idx = sel.topk(cfg.top_k, dim=-1).indices
    weights = scores.gather(-1, expert_idx)
    if cfg.route_norm:
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-20)
    weights = weights * cfg.route_scale

    expert_idx = expert_idx.int()
    if not stats:
        return RouteResult(expert_idx, weights.float(), scores)
    with torch.no_grad():
        # bincount by scatter: torch.bincount reads its max on the host
        flat = expert_idx.reshape(-1).long()
        counts = torch.zeros(E, dtype=torch.int64, device=flat.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        # a device divisor: a true division on the card too
        load = counts.float() / torch.tensor(float(max(flat.numel(), 1)),
                                             device=flat.device)
        mean_score = scores.reshape(-1, E).mean(0)
        aux = E * torch.sum(load * mean_score)
    return RouteResult(expert_idx, weights.float(), scores, load, aux)


def groups_per_token(expert_idx: torch.Tensor,
                     cfg: MoEConfig) -> torch.Tensor:
    """Number of distinct expert groups each token touches (the paper's M,
    the deduplicated inter-node message count); M <= ``group_limit``."""
    g = expert_idx.long() // (cfg.num_experts // cfg.num_groups)
    onehot = torch.zeros((*g.shape[:-1], cfg.num_groups), dtype=torch.bool,
                         device=g.device)
    onehot.scatter_(-1, g, True)
    return onehot.sum(-1)


def update_bias(bias: torch.Tensor, load: torch.Tensor,
                lr: float = 1e-3) -> torch.Tensor:
    """Aux-loss-free balancing: push the bias up for under-loaded experts,
    down for over-loaded ones (sign update).

    As the reference: ``target = 1 / bias.shape[0]``. The trainer passes
    a segment's stacked ``(n, E)`` bias, so the target is ``1 / n`` there,
    not ``1 / E`` (ROADMAP.md §C, the reference's own behaviours)."""
    target = 1.0 / bias.shape[0]
    return bias + lr * torch.sign(target - load)
