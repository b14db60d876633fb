"""Node-limited TopK expert selection (paper §4.3, T3) with aux-loss-free
bias balancing (DeepSeek-V3) — port of ``repro.core.routing.route``.

  scores  = score_fn(x @ Wg)                  (sigmoid for V3)
  select  on scores + bias (selection only, never the mixture weights)
  group_score(g) = sum of top-``group_top`` biased scores in group g
  keep top-``group_limit`` groups, mask the rest, take top-k experts
  weights = scores of the selected experts, renormalized, x route_scale
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MoEConfig


class RouteResult(NamedTuple):
    expert_idx: torch.Tensor   # (..., k) int32
    weights: torch.Tensor      # (..., k) fp32
    scores: torch.Tensor       # (..., E) fp32 post-activation scores


def route(x: torch.Tensor, w_gate: torch.Tensor, cfg: MoEConfig,
          bias: Optional[torch.Tensor] = None) -> RouteResult:
    """x: (..., d); w_gate: (d, E); bias: (E,) or None."""
    if cfg.score_fn != "sigmoid":
        raise NotImplementedError(
            f"score_fn={cfg.score_fn!r}: the port routes with DeepSeek-V3's "
            "sigmoid scores only so far")
    scores = torch.sigmoid(torch.matmul(x.float(), w_gate.float()))

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

    return RouteResult(expert_idx.int(), weights.float(), scores)
