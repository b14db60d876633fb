"""Multi-Token Prediction module (paper §2.3.3, T6) — port of
``repro.core.mtp``: the training loss and the serving draft.

Each MTP module m (depth starts at 1) is a single extra transformer block:

    h'_k = W_proj [ RMSNorm(h_k) ; RMSNorm(Emb(t_{k+m})) ]
    h_k  = Block_m(h'_k)           -> logits for t_{k+m+1} (shared unemb)

Training adds ``loss_weight``-scaled CE per module (:func:`mtp_losses`).
At serving, module 1 drafts the token after the one the main model emits
this step (same-step speculation, ``mtp_draft_tokens``); the fused decode
loop verifies it against that step's sample and counts acceptances. The
block is supplied by the host model (``block_specs``/``block_apply``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import linear, rmsnorm
from repro_torch.models.param import ParamSpec, layer


def mtp_specs(cfg: ModelConfig, block_specs: Callable[[int], dict]) -> dict:
    d, pd = cfg.d_model, cfg.param_dtype
    n = cfg.mtp.num_modules
    L, la = (n,), ("layers",)
    return {
        "norm_h": ParamSpec(L + (d,), pd, la + (None,), "ones"),
        "norm_e": ParamSpec(L + (d,), pd, la + (None,), "ones"),
        "w_proj": ParamSpec(L + (2 * d, d), pd, la + (None, "embed"),
                            "fan_in"),
        "block": block_specs(n),
    }


def mtp_hidden(p_m: dict, h: torch.Tensor, emb_next: torch.Tensor, *,
               cfg: ModelConfig, positions: torch.Tensor,
               block_apply: Callable) -> torch.Tensor:
    """One MTP module. p_m: this module's param slice. h: (B,S,d) hidden
    from the previous depth; emb_next: (B,S,d) embeddings of tokens shifted
    by the module depth. Returns the module's output hidden (B,S,d)."""
    x = torch.cat([rmsnorm(h, p_m["norm_h"], cfg.rms_eps),
                   rmsnorm(emb_next, p_m["norm_e"], cfg.rms_eps)], dim=-1)
    x = linear(x, p_m["w_proj"], cfg)
    return block_apply(p_m["block"], x, positions)


def mtp_losses(p: dict, h: torch.Tensor, tokens: torch.Tensor,
               emb_fn: Callable, unemb_fn: Callable, *, cfg: ModelConfig,
               positions: torch.Tensor, block_apply: Callable,
               rows: Optional[int] = None) -> torch.Tensor:
    """Summed weighted CE over MTP depths. tokens: (B,S) inputs; the target
    of depth m at position k is tokens[k+m+1] (the last m+1 positions,
    whose targets wrap around, are masked out). Returns a scalar.
    ``rows``: the batch rows each mean is over (default B; a data rank
    passes the global batch's, so its loss is its part of the mean)."""
    n = cfg.mtp.num_modules
    B, S = tokens.shape
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for m in range(1, n + 1):
        # input tokens shifted by m: at position k we feed Emb(t_{k+m})
        shifted = torch.roll(tokens, -m, dims=1)
        h = mtp_hidden(layer(p, m - 1), h, emb_fn(shifted), cfg=cfg,
                       positions=positions, block_apply=block_apply)
        logits = unemb_fn(h).float()                     # (B,S,V)
        targets = torch.roll(tokens, -(m + 1), dims=1).long()
        valid = torch.arange(S, device=tokens.device) < S - (m + 1)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, targets[..., None])[..., 0]
        ce = torch.where(valid[None, :], lse - ll, 0.0)
        # a device divisor: a true division on the card too
        count = torch.tensor(float(max(max(S - (m + 1), 0) * (rows or B),
                                       1)),
                             device=tokens.device)
        total = total + cfg.mtp.loss_weight / n * (ce.sum() / count)
    return total


def mtp_draft(p: dict, h_last: torch.Tensor, emb_next: torch.Tensor, *,
              cfg: ModelConfig, positions: torch.Tensor,
              block_apply: Callable, unemb_fn: Callable) -> torch.Tensor:
    """Decode-time draft: given the main model's last hidden h_last (B,1,d)
    and the embedding of the token it just produced, return draft logits
    for the token after next. Uses module depth 1."""
    h = mtp_hidden(layer(p, 0), h_last, emb_next, cfg=cfg,
                   positions=positions, block_apply=block_apply)
    return unemb_fn(h)


def mtp_draft_tokens(params: dict, cache: dict, cfg: ModelConfig,
                     last_tokens: torch.Tensor, positions: torch.Tensor,
                     embed_fn: Callable, unembed_fn: Callable
                     ) -> torch.Tensor:
    """Greedy draft token per slot, one step of MTP module 1.

    Runs the module at position ``positions - 1`` on the pair ``(h_{p-1},
    Emb(t_p))`` — the hidden carried in ``cache['mtp_h']`` and the slot's
    current token — against the module's own dense ring ``cache['mtp']``
    (filled over the prompt at prefill), which the step writes in place.
    The block attends on the plain path, as the reference's draft does.
    last_tokens/positions: (B,) — the token each slot emitted last step
    and its position. Returns draft (B,) int32: the module's guess at the
    token the current step is about to emit."""
    from repro_torch.models import transformer as tfm
    ring = layer(cache["mtp"], 0)

    def bapply(pb, x, pos):
        return tfm.block_apply(pb, x, cfg, dict(positions=pos), ring)[0]

    logits = mtp_draft(params["mtp"], cache["mtp_h"],
                       embed_fn(last_tokens[:, None]), cfg=cfg,
                       positions=positions[:, None] - 1,
                       block_apply=bapply, unemb_fn=unembed_fn)
    return logits[:, 0].argmax(dim=-1).int()


def mtp_align_head(params: dict) -> dict:
    """Rewrite the MTP head so module 1's draft is exactly the main model's
    greedy argmax at the draft position (test and bench utility).

    Zeroes every MTP parameter (pre-norm residual blocks become identity),
    then sets ``norm_h`` to ones and ``w_proj`` to ``[I; 0]``, so the
    module's output is ``rmsnorm(h)``; the shared unembedding normalizes
    again, and rmsnorm is scale-invariant, so the draft is the greedy
    token after ``h``. Takes raw weights: apply it before
    ``bridge.prepare_for_serving``."""
    if params.get("prepared"):
        raise ValueError("mtp_align_head rewrites raw weights; apply it "
                         "before bridge.prepare_for_serving")

    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return torch.zeros_like(t)

    w = params["mtp"]["w_proj"]
    n, d2, d = w.shape
    eye = torch.eye(d, device=w.device)
    m = zeros(params["mtp"])
    m["w_proj"] = torch.cat([eye, eye.new_zeros(d2 - d, d)]).expand(
        n, d2, d).to(w.dtype).contiguous()
    m["norm_h"] = torch.ones_like(params["mtp"]["norm_h"])
    return dict(params, mtp=m)
