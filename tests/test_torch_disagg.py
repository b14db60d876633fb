"""PyTorch port: prefill/decode disaggregation (``serve/disagg.py``)
against the JAX package, as the disaggregation cases of
``tests/test_serving.py`` and ``tests/test_paged_cache.py`` run it.

Each run takes the same requests through the JAX ``Disaggregator`` (its
registry's ``ref`` backend) and the port's, on the same weights
(``bridge.params_from_jax``): smoke DeepSeek-V3 with the MoE capacity
factor of those tests, on the dense engine and on paged engines with bf16
and fp8 pages. Greedy streams, each handoff's bytes and ``handoff_bytes``
must be equal, and the port's streams equal to its own engine admitting
the same requests itself.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.serve import disagg as jdisagg
from repro.serve.engine import Request as JRequest
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.parallel.context import ParallelCtx
from repro_torch.serve import disagg
from repro_torch.serve.engine import AdmissionError, Request, ServeEngine
from _torch_threads import one_thread  # noqa: F401


def _wide_moe(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@pytest.fixture(scope="module")
def dsv3():
    cfg = _wide_moe(smoke_config(get_config("deepseek-v3-671b")))
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jp, _wide_moe(tsmoke(tget("deepseek-v3-671b"))), tp


def _prompts(vocab, n=3):
    return [np.arange(4 + i * 3) * (i + 3) % vocab for i in range(n)]


# handoff layouts: the dense engine's batch-1 max_len cache, and paged
# engines' page payloads at native (fp32 at smoke width) and fp8 storage
LAYOUTS = {"dense": {},
           "bf16": dict(paged=True, page_size=8, page_storage="bf16"),
           "fp8": dict(paged=True, page_size=8, page_storage="fp8")}


def _disagg(port, weights, layout, n=3, max_new=4):
    cfg, jp, tcfg, tp = weights
    mod, R = (disagg, Request) if port else (jdisagg, JRequest)
    kw = dict(device="cpu") if port else {}
    dis = mod.Disaggregator(tcfg if port else cfg,
                            params=tp if port else jp, decode_slots=2,
                            max_len=32, chunk=4, **LAYOUTS[layout], **kw)
    reqs = [R(i, p, max_new=max_new)
            for i, p in enumerate(_prompts(cfg.vocab_size, n))]
    for r in reqs:
        dis.submit(r)
    nbytes = [h.nbytes for h in dis.queue]
    assert nbytes == [mod.cache_nbytes(h.cache1) for h in dis.queue]
    dis.run()
    assert not dis.queue
    assert all(r is None for r in dis.decode.active)
    return dict(streams=[list(r.out) for r in reqs],
                done=[r.done for r in reqs], nbytes=nbytes,
                handoff=dis.handoff_bytes, free=dis.decode.free_pages())


@pytest.fixture(scope="module")
def jax_runs(dsv3):
    with kernels.use_backend("ref"):
        return {lay: _disagg(False, dsv3, lay) for lay in LAYOUTS}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_handoffs_equal_jax(dsv3, jax_runs, layout):
    """The same streams, the same bytes per handoff and in all, as the JAX
    disaggregator; and the streams of the port's engine admitting the
    requests itself (prefill and admission in one tick)."""
    ours = _disagg(True, dsv3, layout)
    assert ours == jax_runs[layout]
    assert all(ours["done"]) and ours["handoff"] == sum(ours["nbytes"]) > 0
    _, _, tcfg, tp = dsv3
    eng = ServeEngine(tcfg, params=tp, slots=2, max_len=32, chunk=4,
                      device="cpu", **LAYOUTS[layout])
    reqs = [Request(i, p, max_new=4)
            for i, p in enumerate(_prompts(tcfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert [list(r.out) for r in reqs] == ours["streams"]


def test_fp8_pages_ship_fewer_bytes(jax_runs):
    """Paged handoffs are the quantized pages of the prompt's bucket: fp8
    under 0.55x the native payload, both under the dense max_len ring."""
    dense, native, fp8 = (sum(jax_runs[k]["nbytes"])
                          for k in ("dense", "bf16", "fp8"))
    assert fp8 <= 0.55 * native
    assert fp8 < native < dense


def test_bounded_queue_and_validation(dsv3):
    _, _, tcfg, tp = dsv3
    dis = disagg.Disaggregator(tcfg, params=tp, decode_slots=1, max_len=32,
                               max_queue=2, device="cpu")
    for rid in range(2):
        dis.submit(Request(rid, np.arange(4), max_new=4))
    with pytest.raises(AdmissionError, match="handoff queue full"):
        dis.submit(Request(2, np.arange(4), max_new=4))
    dis.run()
    assert all(r is None for r in dis.decode.active)
    paged = disagg.Disaggregator(tcfg, params=tp, decode_slots=1,
                                 max_len=32, device="cpu", **LAYOUTS["bf16"])
    with pytest.raises(ValueError, match="ring-wraps"):
        paged.submit(Request(0, np.arange(20), max_new=20))
    # without a prefill_ctx the decode pool prefills itself (an unmeshed
    # ctx here; a meshed one in tests/test_torch_serve_mesh.py)
    one = disagg.Disaggregator(tcfg, params=tp, device="cpu",
                               ctx=ParallelCtx())
    assert not dis.cross_mesh and not one.cross_mesh
    assert one.prefill_pool is one.decode
