"""RecurrentGemma blocks: RG-LRU recurrent mixer + local (sliding-window)
attention, in a 2:1 pattern — port of ``repro.models.rglru``.
[arXiv:2402.19427]

The RG-LRU recurrence is

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = a^(c * r_t),  a = sigmoid(lam)  (per-channel decay, c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

computed with an associative scan (train/prefill: :func:`_assoc_scan`,
the reference's ``jax.lax.associative_scan`` recursion, so the products
happen in its order) or a single-step update (decode). Decode state =
(conv tail, h), O(1) in sequence length; a decode step writes both in
place.

Under a mesh ctx (``parallel/context``) the block is tensor-parallel over
the model group by channels, on the reference's placements: ``w_x`` and
``w_y`` are column-parallel (one ``layers.to_columns`` input for both),
the conv holds the rank's channels, and so do the cached conv tail and
``h``. ``wa`` and ``wi`` hold the rows of the rank's channels, so a
rank's gate product is a partial over the whole width: it is
reduce-scattered along the width (``collectives.scatter_sum``), which
leaves each rank the sum for its own channels. ``ba``, ``bi`` and ``lam``
are replicated and each rank takes its channels of them (their gradients
summed over the group). The scan is per channel and stays local;
``w_out`` is row-parallel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as Lyr
from repro_torch.models.param import ParamSpec
from repro_torch.models.ssm import _causal_conv, softplus
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx

C_EXP = 8.0


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def recurrent_block_specs(cfg: ModelConfig, n: int) -> dict:
    d, pd = cfg.d_model, cfg.param_dtype
    w = _lru_width(cfg)
    L, la = (n,), ("layers",)
    return {
        "ln1": ParamSpec(L + (d,), pd, la + (None,), "ones"),
        "w_x": ParamSpec(L + (d, w), pd, la + ("embed", "mlp"), "fan_in"),
        "w_y": ParamSpec(L + (d, w), pd, la + ("embed", "mlp"), "fan_in"),
        "conv_w": ParamSpec(L + (cfg.rglru.conv_width, w), pd,
                            la + (None, "mlp"), "normal", 0.5),
        "conv_b": ParamSpec(L + (w,), pd, la + ("mlp",), "zeros"),
        "wa": ParamSpec(L + (w, w), "float32", la + ("mlp", None), "fan_in"),
        "ba": ParamSpec(L + (w,), "float32", la + (None,), "zeros"),
        "wi": ParamSpec(L + (w, w), "float32", la + ("mlp", None), "fan_in"),
        "bi": ParamSpec(L + (w,), "float32", la + (None,), "zeros"),
        "lam": ParamSpec(L + (w,), "float32", la + (None,), "normal", 50.0),
        "w_out": ParamSpec(L + (w, d), pd, la + ("mlp", "embed"), "fan_in"),
        "ln2": ParamSpec(L + (d,), pd, la + (None,), "ones"),
        "mlp": Lyr.mlp_specs(cfg, n),
    }


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 sqrt, as XLA's: CUDA's is; the CPU's
    vectorized one is not always, so the CPU takes it through float64."""
    return t.sqrt() if t.is_cuda else torch.sqrt(t.double()).float()


def _combine(a1, b1, a2, b2):
    """The scan's operator on (a, b) pairs, earlier pair first:
    h -> a2 (a1 h + b1) + b2."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along axis 1 (``even`` as
    long as ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of :func:`_combine` along axis 1 by the recursion of
    ``jax.lax.associative_scan``: adjacent pairs reduced, the half-length
    scan recursed, the even positions combined from it. log2(S) levels of
    a few batched ops each, no loop over S."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _gates(x: torch.Tensor, p: dict):
    """(a, the gated input) of the recurrence from x (B,S,w) fp32: this
    rank's channels of it under a model group (module docstring)."""
    c = pctx.get()
    group = c.tp_group
    ba, bi, lam = p["ba"], p["bi"], p["lam"]
    if group is None:
        ra, ia = torch.matmul(x, p["wa"]), torch.matmul(x, p["wi"])
    else:
        w = x.shape[-1]
        if w == p["wa"].shape[-1]:
            raise ValueError(f"the RG-LRU width {w} does not split over "
                             f"{c.model_size} model columns")
        w0 = c.index(c.tp_axis) * w
        own = slice(w0, w0 + w)
        ra = coll.scatter_sum(torch.matmul(x, p["wa"]), group, x.dim() - 1)
        ia = coll.scatter_sum(torch.matmul(x, p["wi"]), group, x.dim() - 1)
        ba, bi, lam = (coll.copy_to_group(t, group)[..., own]
                       for t in (ba, bi, lam))
    r = torch.sigmoid(ra + ba)
    i = torch.sigmoid(ia + bi)
    a = torch.exp(-C_EXP * softplus(lam) * r)         # a^(c r), a=sig(lam)
    gated = _sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x)
    return a, gated


def _rg_lru(x: torch.Tensor, p: dict, h0: Optional[torch.Tensor],
            valid: Optional[torch.Tensor] = None):
    """x: (B,S,w) fp32. Returns (y, h_last). ``valid`` (B,S) gates padded
    positions to the identity update (a=1, input 0) so the carried state —
    including h_last — is the state after the last real token."""
    a, gated = _gates(x, p)
    if valid is not None:
        a = torch.where(valid[..., None], a, 1.0)
        gated = torch.where(valid[..., None], gated, 0.0)
    aa, bb = _assoc_scan(a, gated)
    h = bb if h0 is None else bb + aa * h0[:, None]
    return h, h[:, -1]


def recurrent_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                          ctx: dict, cache=None):
    """cache (decode): dict(conv (B,K-1,w), h (B,w)), written in place.
    Prefill returns ``(conv tail, h_last)`` as its cache entries when
    ``ctx["collect_cache"]``. Returns (x, cache_out, stats)."""
    res = x
    # under a sequence cut x is this rank's chunk of tokens: the norms'
    # gradients are summed over the group, and the column-parallel input
    # gathers the sequence, which the scan runs whole
    sp = pctx.seq_group()
    h = Lyr.to_columns(Lyr.rmsnorm(x, coll.copy_to_group(p["ln1"], sp),
                                   cfg.rms_eps))
    branch_y = Lyr.act_fn("gelu")(Lyr.linear(h, p["w_y"], cfg))
    bx = Lyr.linear(h, p["w_x"], cfg)
    conv_state = cache["conv"] if cache is not None else None
    collect = cache is None and ctx.get("collect_cache")
    bx, new_conv = _causal_conv(
        bx, p["conv_w"], p["conv_b"], conv_state,
        lengths=ctx.get("prompt_lengths") if collect else None)
    bx32 = bx.float()

    if cache is not None:
        a, gated = _gates(bx32, p)
        hn = a[:, 0] * cache["h"].float() + gated[:, 0]
        y = hn[:, None]
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(hn)
        cache_out = cache
    else:
        y, h_last = _rg_lru(bx32, p, None,
                            valid=ctx.get("valid") if collect else None)
        cache_out = (new_conv, h_last) if collect else None

    y = y.to(x.dtype) * branch_y
    x = res + Lyr.linear(y, p["w_out"], cfg, tp="row")
    f = Lyr.mlp(p["mlp"], Lyr.rmsnorm(x, coll.copy_to_group(p["ln2"], sp),
                                      cfg.rms_eps), cfg)
    return x + f, cache_out, {}


def init_rglru_cache(cfg: ModelConfig, layers: int, batch: int,
                     device) -> dict:
    """``conv`` (layers, batch, K-1, w) in the model dtype and ``h``
    (layers, batch, w) in fp32."""
    w = _lru_width(cfg)
    return dict(
        conv=torch.zeros((layers, batch, cfg.rglru.conv_width - 1, w),
                         dtype=torch_dtype(cfg.dtype), device=device),
        h=torch.zeros((layers, batch, w), dtype=torch.float32,
                      device=device))
