"""The stream harness of ``test_torch_archs_serve.py``,
``test_torch_archs_paged.py``, ``test_torch_archs_moe.py``,
``test_torch_archs_llama4.py`` and ``test_torch_archs_pairs.py``: the
same requests through the JAX
``ServeEngine`` (its registry's ``ref`` backend) and the port's, on the
same smoke weights (``bridge.params_from_jax``), greedy.

Engine modes: the dense engine, paged bf16 and fp8 pages, and chunked
prefill (fp8 pages, chunks of 8: the prompts take 1, 2 and 3 chunks); each
on the default path and on the kernel path (``attn_impl`` and
``fp8_impl`` "pallas": the port's registry ops, whose plain versions run
on CPU tensors). MoE configs serve at the reference's parity
``capacity_factor`` 8.0, so no token is dropped at decode.
"""
import dataclasses

import jax
import numpy as np

from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.kernels import registry
from repro_torch.serve.engine import Request, ServeEngine

MODES = {"dense": dict(paged=False),
         "paged-bf16": dict(paged=True, page_storage="bf16"),
         "paged-fp8": dict(paged=True, page_storage="fp8"),
         "chunked": dict(paged=True, page_storage="fp8", prefill_chunk=8)}
KW = dict(slots=2, max_len=32, seed=0, chunk=4, page_size=8)
LENGTHS = (5, 11, 17)
MAX_NEW = 6


def configs(arch, kernel_path=False):
    """(JAX cfg, port cfg) at smoke width; MoE at capacity factor 8."""
    impl = "pallas" if kernel_path else "ref"
    out = []
    for cfg in (smoke_config(get_config(arch)), tsmoke(tget(arch))):
        if cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        out.append(dataclasses.replace(cfg, fp8_impl=impl))
    return tuple(out)


def weights(arch):
    """The JAX init (and its numpy copy) of ``arch``'s smoke config."""
    cfg, _ = configs(arch)
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def prompts(vocab):
    return [np.arange(L) * (i + 3) % vocab for i, L in enumerate(LENGTHS)]


def run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    return [list(map(int, r.out)) for r in reqs]


def jax_streams(arch, jp, mode, kernel_path):
    cfg, _ = configs(arch, kernel_path)
    attn = "pallas" if kernel_path else ""
    with kernels.use_backend("ref"):
        eng = JServeEngine(cfg, params=jp, attn_impl=attn, **MODES[mode],
                           **KW)
        return run(eng, [JRequest(i, p, max_new=MAX_NEW)
                          for i, p in enumerate(prompts(cfg.vocab_size))])


def port_engine(arch, npp, mode, kernel_path):
    _, tcfg = configs(arch, kernel_path)
    return ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                       attn_impl="pallas" if kernel_path else "",
                       device="cpu", **MODES[mode], **KW)


def port_streams(eng):
    return run(eng, [Request(i, p, max_new=MAX_NEW)
                      for i, p in enumerate(prompts(eng.cfg.vocab_size))])


def check_streams(arch, weights_, mode, kernel_path):
    """The port's streams equal the JAX engine's; a paged engine has every
    page back at the end."""
    jp, npp = weights_
    ref = jax_streams(arch, jp, mode, kernel_path)
    eng = port_engine(arch, npp, mode, kernel_path)
    ours = port_streams(eng)
    assert ours == ref
    assert all(len(o) == MAX_NEW for o in ours)
    if eng.paged:
        assert eng.free_pages() == eng.pool_pages
    return eng


def flat(tree, path=()):
    """A nested dict as {key path: leaf}."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in flat(tree[k], path + (k,))
                .items()}
    return {path: tree}


def counted_ops(monkeypatch):
    """Count each registry op's calls (their plain versions, on CPU
    tensors)."""
    calls = {}
    for name in registry.names():
        op = registry.get(name)

        def counted(*a, _plain=op._plain, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **k)
        monkeypatch.setattr(op, "_plain", counted)
    return calls
