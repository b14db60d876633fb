"""Mamba-2 SSD (state-space duality) blocks — port of
``repro.models.ssm``. [arXiv:2405.21060]

The paper (§2.1.3) points at Mamba-2 as the linear-time direction for the
KV-cache problem; this module implements the SSD mixer:

* train/prefill: chunked SSD — within-chunk quadratic (attention-like)
  products + inter-chunk linear state recurrence (O(N) in sequence).
* decode: O(1)-per-token recurrent state update. The recurrent state
  (nheads, head_dim, d_state) is the whole decode state: its size does not
  grow with the context.

Layout follows the reference Mamba-2: in_proj -> [z, x, B, C, dt],
depthwise conv on (x,B,C), SSD, gated RMSNorm, out_proj. n_groups = 1.

A decode step writes the cache slice it is given in place (``conv`` and
``state`` are ``copy_``'d, never rebound), so a captured decode chunk
reads and writes the same buffers at every replay.

Under a mesh ctx (``parallel/context``) the block is tensor-parallel by
heads over the model group: each rank runs the conv, the SSD scan and the
decode update over its H/m heads (their z, x and dt, with B and C whole,
one group). The weights keep the reference's placements: ``a_log``,
``dt_bias``, ``D``, ``norm`` and ``w_out``'s rows fall on whole heads
(``d_in`` is head-major), but a contiguous cut of ``w_in``'s columns (z |
x | B | C | dt) or of the conv's channels (x | B | C) is not a cut by
heads. So the column-parallel product's output is gathered over the
group and each rank takes its heads' columns from it (the gather's
backward reduce-scatters, which sums B's and C's gradients); the conv's
weights and bias, a few rows, are gathered the same way, in one
collective. The gated RMSNorm sums each token's squares over the group
(one fp32 value a token) and ``w_out`` is row-parallel. A rank's cache
holds its heads' ``state`` and a ``conv`` tail of its heads' x channels,
then B and C (``sharding.Tail``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models.layers import linear, rmsnorm, to_columns
from repro_torch.models.param import ParamSpec
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    return s, s.d_inner(cfg.d_model), s.num_heads(cfg.d_model)


def ssd_block_specs(cfg: ModelConfig, n: int) -> dict:
    s, d_in, H = _dims(cfg)
    d, pd = cfg.d_model, cfg.param_dtype
    N = s.d_state
    L, la = (n,), ("layers",)
    conv_ch = d_in + 2 * N                     # x, B, C go through the conv
    return {
        "ln": ParamSpec(L + (d,), pd, la + (None,), "ones"),
        "w_in": ParamSpec(L + (d, 2 * d_in + 2 * N + H), pd,
                          la + ("embed", "mlp"), "fan_in"),
        "conv_w": ParamSpec(L + (s.d_conv, conv_ch), pd, la + (None, "mlp"),
                            "normal", 0.5),
        "conv_b": ParamSpec(L + (conv_ch,), pd, la + ("mlp",), "zeros"),
        "a_log": ParamSpec(L + (H,), "float32", la + ("heads",), "zeros"),
        "dt_bias": ParamSpec(L + (H,), "float32", la + ("heads",), "zeros"),
        "D": ParamSpec(L + (H,), "float32", la + ("heads",), "ones"),
        "norm": ParamSpec(L + (d_in,), pd, la + ("mlp",), "ones"),
        "w_out": ParamSpec(L + (d_in, d), pd, la + ("mlp", "embed"),
                           "fan_in"),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d_in, H = _dims(cfg)
    N = s.d_state
    return torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)


def _whole(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """``t`` whole along its last axis (``size``) on every member of
    ``group``, each member using its own part of it: a member's cut is
    gathered (``collectives.gather``), a replicated ``t`` enters through
    ``copy_to_group``; either backward sums the members' gradients."""
    if t.shape[-1] == size:
        return coll.copy_to_group(t, group)
    return coll.gather(t, group, t.dim() - 1, backward="reduce_scatter")


def _heads_of(cfg: ModelConfig, group_size: int, index: int):
    """``(channels, heads)``: the slices of ``d_in`` and of the heads that
    model rank ``index`` of ``group_size`` runs (all of them unmeshed).
    Raises where the heads do not split over the group."""
    s, d_in, H = _dims(cfg)
    if H % group_size:
        raise ValueError(f"Mamba-2's {H} heads do not split over "
                         f"{group_size} model columns")
    hl = H // group_size
    return (slice(index * hl * s.head_dim, (index + 1) * hl * s.head_dim),
            slice(index * hl, (index + 1) * hl))


def _own_heads(cfg: ModelConfig, zxbcdt: torch.Tensor, p: dict):
    """``(z, xbc, dt, conv_w, conv_b)`` of this rank's heads from its
    column-parallel ``zxbcdt`` and conv weights (module docstring): z, x
    and dt of its heads, B and C whole; unmeshed, the split of the whole
    projection."""
    s, d_in, H = _dims(cfg)
    N = s.d_state
    c = pctx.get()
    group = c.tp_group
    if group is None:
        z, xbc, dt = _split_proj(cfg, zxbcdt)
        return z, xbc, dt, p["conv_w"], p["conv_b"]
    ch, hd = _heads_of(cfg, c.model_size, c.index(c.tp_axis))
    zx = _whole(zxbcdt, group, 2 * d_in + 2 * N + H)
    # the conv's weights and bias, one gather
    cwb = _whole(torch.cat([p["conv_w"], p["conv_b"][None]]), group,
                d_in + 2 * N)
    cw, cb = cwb[:-1], cwb[-1]

    def xbc_of(t, x0):                   # this rank's x channels, B, C
        return torch.cat([t[..., x0 + ch.start:x0 + ch.stop],
                          t[..., x0 + d_in:x0 + d_in + 2 * N]], dim=-1)

    dt0 = 2 * d_in + 2 * N
    return (zx[..., ch], xbc_of(zx, d_in),
            zx[..., dt0 + hd.start:dt0 + hd.stop], xbc_of(cw, 0),
            xbc_of(cb, 0))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """``rmsnorm(y * silu(z), gamma)`` over the whole ``d_in``: under a
    model group each token's squares are summed over it (one fp32 value a
    token; the backward sums each member's gradient of the sum)."""
    group = pctx.get().tp_group
    g = y * F.silu(z)
    if group is None:
        return rmsnorm(g, gamma, cfg.rms_eps)
    gf = g.float()
    ss = coll.copy_to_group(coll.reduce_sum(
        (gf * gf).sum(dim=-1, keepdim=True), group), group)
    d_in = _dims(cfg)[1]
    return (gf * torch.rsqrt(ss / d_in + cfg.rms_eps)
            * gamma.float()).to(g.dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width K. xbc: (B,S,C). state: (B,K-1,C) tail
    of previous tokens (decode). Returns (out, new_state).

    ``lengths`` (B,) supports bucket-padded prefill: the returned conv tail
    is gathered per row at the last K-1 *real* positions (pads sit after
    them, so real conv outputs are unaffected either way)."""
    K = w.shape[0]
    B, S, C = xbc.shape
    if state is None:
        pad = xbc.new_zeros((B, K - 1, C))
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                  # (B, S+K-1, C)
    out = 0
    for i in range(K):                     # the reference's sum, in order
        out = out + full[:, i:i + S] * w[i]
    out = F.silu(out + b)
    if lengths is None:
        new_state = full[:, -(K - 1):]
    else:
        # full index i holds token position i-(K-1); tail = positions
        # lengths-K+1 .. lengths-1  ->  full indices lengths .. lengths+K-2
        idx = (lengths.long()[:, None]
               + torch.arange(K - 1, device=xbc.device)[None, :])
        new_state = torch.gather(full, 1, idx[..., None].expand(B, K - 1, C))
    return out, new_state


def _ssd_scan(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD. x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) <0;
    Bm/Cm: (B,S,N). Returns (y (B,S,H,P), final_state (B,H,P,N)), fp32.

    Standard SSD decomposition: within-chunk 'attention' term + inter-chunk
    recurrent term, both exact."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    assert S % chunk == 0, (S, chunk)
    f32 = torch.float32

    xc = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    la = dtc * A                                        # log decay per step
    cum = torch.cumsum(la, dim=2)                       # (B,nc,Q,H)
    # within-chunk: y_intra[t] = sum_{s<=t} C_t·B_s dt_s exp(cum_t - cum_s) x_s
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    # exp of -inf above the diagonal: the reference's where(tri, exp, 0)
    # value, without an overflowing exp for the backward to multiply by 0
    decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)        # (B,nc,Q,Q)
    w_ts = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", w_ts, xc)

    # chunk summary: state contribution of each chunk
    rem = cum[:, :, -1:, :] - cum                       # decay from s to end
    contrib = torch.einsum("bcsh,bcsn,bcshp->bchpn",
                           dtc * torch.exp(rem), Bc, xc)  # (B,nc,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B,nc,H)

    # inter-chunk recurrence over nc (sequential; nc is small)
    st = x.new_zeros((Bsz, H, P, N), dtype=f32)
    starts = []
    for c in range(nc):
        starts.append(st)
        st = st * chunk_decay[:, c, :, None, None] + contrib[:, c]
    S_starts = torch.stack(starts, dim=1)               # (B,nc,H,P,N)

    # inter-chunk output: y_inter[t] = C_t · (exp(cum_t) * S_chunk_start)
    y_inter = torch.einsum("bctn,bcth,bchpn->bcthp",
                           Cc, torch.exp(cum), S_starts)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, st


def ssd_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: dict,
                    cache=None):
    """Full SSD block. cache (decode): dict(conv (B,K-1,C), state
    (B,H,P,N)), written in place. Prefill returns ``(conv tail, final
    state)`` as its cache entries when ``ctx["collect_cache"]``. Returns
    (x, cache_out, stats)."""
    s = cfg.ssm
    N, P = s.d_state, s.head_dim
    H = p["a_log"].shape[-1]                     # this rank's heads
    d_in = H * P
    res = x
    # under a sequence cut x is this rank's chunk of tokens: the norm's
    # gradient is summed over the group, and the column-parallel input
    # gathers the sequence, which the scan runs whole
    h = rmsnorm(x, coll.copy_to_group(p["ln"], pctx.seq_group()),
                cfg.rms_eps)
    z, xbc, dt, conv_w, conv_b = _own_heads(
        cfg, linear(to_columns(h), p["w_in"], cfg), p)
    conv_state = cache["conv"] if cache is not None else None
    prompt_lengths = (ctx.get("prompt_lengths")
                      if cache is None and ctx.get("collect_cache") else None)
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state,
                                 lengths=prompt_lengths)
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    B_, S_ = xs.shape[0], xs.shape[1]
    xh = xs.reshape(B_, S_, H, P)
    dt = softplus(dt.float() + p["dt_bias"])
    valid = ctx.get("valid")
    if cache is None and valid is not None:
        # bucket-padded prefill: dt=0 makes a pad step the identity update
        # (decay exp(0)=1, contribution dt*B*x = 0), so the collected final
        # state is exactly the state after the last real token.
        dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(p["a_log"].float())                  # (H,) negative

    if cache is not None:
        # single-token recurrent update (S_==1)
        dt1 = dt[:, 0]                                  # (B,H)
        a = torch.exp(dt1 * A)                          # (B,H)
        st = cache["state"].float()
        upd = torch.einsum("bh,bn,bhp->bhpn", dt1, Bm[:, 0].float(),
                           xh[:, 0].float())
        st = st * a[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), st)[:, None]
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(st)
        cache_out = cache
    else:
        chunk = min(s.chunk, S_)
        y, Sf = _ssd_scan(xh, dt, A, Bm, Cm, chunk)
        cache_out = (new_conv, Sf) if ctx.get("collect_cache") else None

    y = y + p["D"].float()[:, None] * xh.float()
    y = y.reshape(B_, S_, d_in).to(x.dtype)
    y = _gated_norm(y, z, p["norm"], cfg)
    return res + linear(y, p["w_out"], cfg, tp="row"), cache_out, {}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``F.softplus``
    switches to ``x`` above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def init_ssd_cache(cfg: ModelConfig, layers: int, batch: int,
                   device) -> dict:
    """``conv`` (layers, batch, K-1, C) in the model dtype and ``state``
    (layers, batch, H, P, N) in fp32: both the same size at any
    context."""
    s, d_in, H = _dims(cfg)
    conv_ch = d_in + 2 * s.d_state
    return dict(
        conv=torch.zeros((layers, batch, s.d_conv - 1, conv_ch),
                         dtype=torch_dtype(cfg.dtype), device=device),
        state=torch.zeros((layers, batch, H, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device))
