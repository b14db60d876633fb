"""The stream harness of ``test_torch_archs_recurrent.py``,
``test_torch_ssm.py`` and ``test_torch_rglru.py``: the recurrent families'
smoke configs (fp32) through the JAX ``ServeEngine`` (its registry's
``ref`` backend) and the port's dense engine, on the same weights
(``bridge.params_from_jax``), greedy.

The smoke window is 32: of the prompts (5, 28, 40, 50 tokens, 8 new
tokens each, two slots), 40 and 50 wrap the windowed ring in prefill and
28 wraps it during decode. ``max_len`` 64 is a power of two, so every
prefill bucket is a whole number of SSD chunks.
"""
import dataclasses

import jax
import numpy as np

import _torch_archs as h
from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.serve.engine import Request, ServeEngine

# (arch, overrides of its smoke config): recurrentgemma at 3 layers is one
# rg3 pattern, at 5 one pattern and a 2-layer rg_tail
CASES = {"mamba2": ("mamba2-2.7b", {}),
         "rglru3": ("recurrentgemma-9b", {}),
         "rglru5": ("recurrentgemma-9b", dict(num_layers=5))}
KW = dict(slots=2, max_len=64, seed=0, chunk=4)
LENGTHS = (5, 28, 40, 50)
MAX_NEW = 8


def configs(case, fp8_on=False):
    """(JAX cfg, port cfg) of ``case`` at smoke width."""
    arch, over = CASES[case]
    return tuple(dataclasses.replace(c, fp8=fp8_on, **over) for c in
                 (smoke_config(get_config(arch)), tsmoke(tget(arch))))


_WEIGHTS = {}


def weights(case):
    """The JAX init of ``case``'s smoke config and its numpy copy (made
    once a process)."""
    if case not in _WEIGHTS:
        cfg, _ = configs(case)
        jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
        _WEIGHTS[case] = (jp, jax.tree.map(np.asarray, jp))
    return _WEIGHTS[case]


def prompts(vocab):
    return [np.arange(L) * (i + 3) % vocab for i, L in enumerate(LENGTHS)]


def jax_streams(case, kernel_path=False, fp8_on=False, **kw):
    cfg, _ = configs(case, fp8_on)
    with kernels.use_backend("ref"):
        eng = JServeEngine(cfg, params=weights(case)[0],
                           attn_impl="pallas" if kernel_path else "",
                           **KW, **kw)
        return h.run(eng, [JRequest(i, p, max_new=MAX_NEW)
                           for i, p in enumerate(prompts(cfg.vocab_size))])


def port_engine(case, kernel_path=False, fp8_on=False, **kw):
    _, tcfg = configs(case, fp8_on)
    return ServeEngine(tcfg, params=bridge.params_from_jax(weights(case)[1]),
                       attn_impl="pallas" if kernel_path else "",
                       device="cpu", **KW, **kw)


def port_streams(eng):
    return h.run(eng, [Request(i, p, max_new=MAX_NEW)
                       for i, p in enumerate(prompts(eng.cfg.vocab_size))])


def rel(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def check_fp8_streams(case):
    """With ``fp8`` (the reference's per-call FP8 linears) the dense
    engine's streams equal the JAX engine's, and the fp32 gate matrices
    ``wa``/``wi`` stay plain tensors."""
    import torch
    ref = jax_streams(case, fp8_on=True)
    eng = port_engine(case, fp8_on=True)
    assert port_streams(eng) == ref
    for p, v in h.flat({k: v for k, v in eng.params.items()
                        if isinstance(v, dict)}).items():
        if p[-1] in ("wa", "wi"):
            assert type(v) is torch.Tensor, p
