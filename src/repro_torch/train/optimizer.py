"""AdamW with the DeepSeek-V3 state-dtype recipe — port of
``repro.train.optimizer``: fp32 master weights, **bf16 first/second
moments**, compute weights in their own dtype (bf16 on the card).

Memory per param: 2 (bf16 w) + 4 (fp32 master) + 2 + 2 (bf16 m, v)
= 10 bytes, plus the bf16 gradient while a step runs.

The port updates the state in place, leaf by leaf and within a leaf
``CHUNK`` elements at a time, so the fp32 temporaries stay bounded (the
DeepSeek-V3 embedding is 0.93 B parameters: 3.7 GB for one fp32 copy).
Each element goes through the reference's arithmetic in the reference's
order, one fp32 rounding per operation; the step's scalars (clip scale,
bias corrections, learning rate) are 0-dim fp32 tensors on the state's
device, so a division is a true division on the card too (CUDA torch
multiplies by the reciprocal of a host scalar divisor).

A leaf whose gradient is ``None`` (the router ``bias``: it selects
experts and has no gradient; the trainer sets it out of band) follows
the reference's arithmetic for a zero gradient, as ``jax.grad`` gives
zeros there.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

# elements of one leaf updated at a time (fp32 temporaries of 256 MB)
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-dim int32
    master: Any          # fp32 copies of params
    m: Any               # bf16 first moment
    v: Any               # bf16 second moment


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> List[
        Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict in sorted-key order (the
    reference's ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_items(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init(params) -> AdamWState:
    some = tree_items(params)[0][1]
    master = tree_map(lambda p: p.detach().float().clone(), params)
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                       device=p.device), params)
    v = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                       device=p.device), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=some.device),
                      master, m, v)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of Σ g² in fp32 (``None`` leaves add
    nothing)."""
    total = None
    for _, g in tree_items(grads):
        if g is None:
            continue
        s = torch.sum(g.float() ** 2)
        total = s if total is None else total + s
    return _sqrt_(total.clone())


def _sqrt_(t: torch.Tensor) -> torch.Tensor:
    """In-place correctly rounded fp32 sqrt. CUDA's is; the CPU's
    vectorized one is not always (one ulp off at some inputs), so there
    it goes through float64, whose square root rounded to fp32 is the
    correctly rounded one."""
    if t.is_cuda:
        return t.sqrt_()
    return t.copy_(torch.sqrt(t.double()))


def _leaf_update(g, master, m, v, p, *, scale, bc1, bc2, lr, b1, b2, eps,
                 wd) -> None:
    """One leaf, in place, CHUNK elements at a time:

        g   = g * scale
        m32 = b1 m + (1 - b1) g
        v32 = b2 v + (1 - b2) g g
        master -= lr (m32/bc1 / (sqrt(v32/bc2) + eps) + wd master)
        p, m, v = master, m32, v32 in their dtypes"""
    n = master.numel()
    fm, mm, vm, pm = (t.view(-1) for t in (master, m, v, p))
    fg = None if g is None else g.reshape(-1)
    for i in range(0, n, CHUNK):
        sl = slice(i, min(i + CHUNK, n))
        ma = fm[sl]
        gc = (torch.zeros_like(ma) if fg is None else fg[sl].float())
        gc.mul_(scale)
        m32 = mm[sl].float().mul_(b1)
        m32.add_(torch.mul(gc, 1 - b1))
        v32 = vm[sl].float().mul_(b2)
        gc = torch.mul(gc, 1 - b2).mul_(gc)
        v32.add_(gc)
        mm[sl].copy_(m32)
        vm[sl].copy_(v32)
        m32.div_(bc1)                        # mh
        _sqrt_(v32.div_(bc2)).add_(eps)      # sqrt(vh) + eps
        m32.div_(v32)
        m32.add_(torch.mul(ma, wd))
        ma.sub_(m32.mul_(lr))
        pm[sl].copy_(ma)


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: Optional[float] = 1.0,
           grad_norm: Optional[torch.Tensor] = None
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """The reference's ``update``, written into ``params`` and ``state`` in
    place. ``grads`` has the nesting of ``params`` (``None`` leaves allowed);
    ``lr`` a float or 0-dim tensor. Returns ``(params, new_state, stats)``
    with ``stats = {"grad_norm": pre-clip norm, "lr": lr}``."""
    p_items = tree_items(params)
    dev = p_items[0][1].device
    f32 = dict(dtype=torch.float32, device=dev)
    step = state.step + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.ones((), **f32)
    if clip_norm is not None:
        scale = torch.clamp_max(torch.div(
            torch.tensor(clip_norm, **f32), torch.clamp_min(gnorm, 1e-12)),
            1.0)
    stepf = step.float()
    bc1 = 1.0 - torch.tensor(b1, **f32) ** stepf
    bc2 = 1.0 - torch.tensor(b2, **f32) ** stepf
    lr_t = torch.as_tensor(lr, **f32).reshape(())

    g_of = dict(tree_items(grads))
    ma_of = dict(tree_items(state.master))
    m_of = dict(tree_items(state.m))
    v_of = dict(tree_items(state.v))
    for path, p in p_items:
        if not p.is_floating_point():
            continue
        wd = weight_decay if p.dim() >= 2 else 0.0  # no decay on norms/bias
        _leaf_update(g_of.get(path), ma_of[path], m_of[path], v_of[path], p,
                     scale=scale, bc1=bc1, bc2=bc2, lr=lr_t, b1=b1, b2=b2,
                     eps=eps, wd=wd)
    stats = {"grad_norm": gnorm, "lr": lr_t}
    return params, AdamWState(step, state.master, state.m, state.v), stats
