"""PyTorch port: GQA decode over the dense ring cache and the dense-cache
engine of qwen3-14b against the JAX reference (``repro.models.layers``,
``repro.serve.engine`` with ``paged=False``).

Weights are the JAX ``Model.init`` tree of smoke qwen3-14b (4 heads over 4
KV heads, G = 1) and of a grouped variant (10 heads over 2 KV heads, G =
5 as at full width), copied through ``bridge.params_from_jax``; inputs
come from numpy seeds. Tolerance: 1e-5 of the largest reference magnitude
(fp32 sums in another order). Greedy token streams must be equal.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.kernels import registry
from repro_torch.models import layers
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_thread  # noqa: F401


RTOL = 1e-5
GROUPS = {"G1": {}, "G5": dict(num_heads=10, num_kv_heads=2)}


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _close(a, b, rtol=RTOL):
    a = a.detach().float().numpy()
    b = np.asarray(jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= rtol * max(float(np.abs(b).max()), 1e-30), err


@pytest.fixture(scope="module", params=sorted(GROUPS))
def qwen(request):
    """Smoke qwen3-14b in both packages at G = 1 and G = 5, one weight
    tree each."""
    over = GROUPS[request.param]
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-14b")), **over)
    tcfg = dataclasses.replace(tsmoke(tget("qwen3-14b")), **over)
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))  # jitted: faster
    return cfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def test_init_gqa_cache_matches_reference(qwen):
    cfg, tcfg, _, _ = qwen
    ref = jlayers.init_gqa_cache(cfg, 2, 3, 16)
    ours = layers.init_gqa_cache(tcfg, 2, 3, 16, "cpu")
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == getattr(torch, str(ref[k].dtype))
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    # a sliding window bounds the ring at min(max_len, window) rows
    for window in (8, 32):
        ref = jlayers.init_gqa_cache(cfg, 2, 3, 16, window=window)
        ours = layers.init_gqa_cache(tcfg, 2, 3, 16, "cpu", window=window)
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(ref[k]))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ring_decode_step_past_a_wrap(qwen, impl):
    """Twelve ``gqa_attention`` decode steps over a ring of 8 rows from
    positions 0, 3 and 6 (every slot wraps): outputs and the written ring
    agree with JAX each step. S = 1 keeps both impls on the direct
    attention path, so no kernel op runs."""
    cfg, tcfg, _, npp = qwen
    jp = jax.tree.map(lambda v: jnp.asarray(v[0]), npp["blocks"]["attn"])
    tp = {k: torch.from_numpy(v[0].copy())
          for k, v in npp["blocks"]["attn"].items()}
    B, T = 3, 8
    jcache = jax.tree.map(lambda v: v[0],
                          jlayers.init_gqa_cache(cfg, 1, B, T))
    cache = {k: v[0] for k, v in layers.init_gqa_cache(tcfg, 1, B, T,
                                                       "cpu").items()}
    g = _gen(("gqa-ring", cfg.num_heads, impl))
    pos = np.array([[0], [3], [6]], np.int32)
    registry.reset_launch_counts()
    for _ in range(12):
        x = g.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jlayers.gqa_attention(
            jp, jnp.asarray(x), cfg=cfg, positions=jnp.asarray(pos),
            cache=jcache, impl=impl)
        out, cache = layers.gqa_attention(
            tp, torch.from_numpy(x), cfg=tcfg,
            positions=torch.from_numpy(pos), cache=cache, impl=impl)
        _close(out, jout)
        pos = pos + 1
    for k in ("k", "v"):
        _close(cache[k], jcache[k], rtol=1e-6)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert not any(registry.launch_counts().values())


@pytest.mark.parametrize("kernel_path", [False, True])
def test_dense_streams_equal_jax_engine(qwen, kernel_path):
    """qwen3-14b on ``ServeEngine(paged=False)``: greedy streams equal the
    JAX dense engine's (its registry on the ``ref`` backend), on the
    default path and on the kernel path (``flash_prefill`` at prefill)."""
    cfg, tcfg, jp, npp = qwen
    attn = "pallas" if kernel_path else ""
    kw = dict(slots=2, max_len=32, seed=0, chunk=4, attn_impl=attn)
    prompts = [np.arange(4 + i * 3) * (i + 3) % cfg.vocab_size
               for i in range(3)]
    with kernels.use_backend("ref"):
        jeng = JServeEngine(cfg, params=jp, **kw)
        jreqs = [JRequest(i, p, max_new=6) for i, p in enumerate(prompts)]
        for r in jreqs:
            jeng.submit(r)
        jeng.run_until_done()
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp), device="cpu",
                      **kw)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert [list(r.out) for r in reqs] == [list(r.out) for r in jreqs]
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert eng.cache_bytes_per_token() == pytest.approx(
        jeng.cache_bytes_per_token())
