"""PyTorch port: RecurrentGemma's RG-LRU block (``models/rglru.py``) and
its sliding-window attention (``models/layers.py``) against the
reference's functions on the same numpy inputs, at smoke width in fp32.

* ``_rg_lru`` (the associative scan, with and without ``valid``, from a
  zero and a carried state, at an odd and an even length): the states and
  the last state within 1e-5 of the largest; with ``valid`` the last state
  is the one after the last real step (within 1e-6).
* ``recurrent_block_apply``: a bucket-padded prefill (the collected conv
  tail and state), then decode steps written in place.
* ``act_fn("gelu")`` against ``jax.nn.gelu`` (the tanh approximation).
* Windowed ``attention_scores`` over a prompt longer than the window, and
  ``gqa_attention``'s ring decode over a ``window``-row ring across its
  wrap: outputs and the written ring as the reference's.
* recurrentgemma's smoke config with ``fp8``: the dense engine's streams
  equal the JAX engine's.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_recurrent import check_fp8_streams, configs, rel, weights
from repro.models import layers as jlayers
from repro.models import rglru as jrg
from repro_torch.models import layers, rglru
from repro_torch.models.param import layer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def block():
    """The first recurrent block of recurrentgemma's smoke weights, both
    packages."""
    jp_all, npp = weights("rglru3")
    cfg, tcfg = configs("rglru3")
    jp = jax.tree.map(lambda v: v[0], jp_all["pat"]["r0"])
    tp = jax.tree.map(lambda v: torch.from_numpy(v[0].copy()),
                      npp["pat"]["r0"])
    return cfg, tcfg, jp, tp


@pytest.mark.parametrize("S", [37, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("carried", [False, True])
def test_rg_lru_matches_jax(block, S, masked, carried):
    cfg, _, jp, tp = block
    g = _gen(("rg-lru", S, masked, carried))
    B, w = 2, cfg.d_model
    x = g.standard_normal((B, S, w)).astype(np.float32)
    h0 = g.standard_normal((B, w)).astype(np.float32) if carried else None
    n = np.asarray([S - 11, S], np.int32)
    valid = (np.arange(S)[None] < n[:, None]) if masked else None
    jh, jlast = jax.jit(jrg._rg_lru)(
        jnp.asarray(x), jp, None if h0 is None else jnp.asarray(h0),
        None if valid is None else jnp.asarray(valid))
    h, last = rglru._rg_lru(_t(x), tp, None if h0 is None else _t(h0),
                            None if valid is None else _t(valid))
    assert rel(h.numpy(), jh) <= 1e-5
    assert rel(last.numpy(), jlast) <= 1e-5
    if masked:
        # the carried state is the state after row 0's last real step (the
        # scan reaches the two positions through other products)
        assert rel(last[0].numpy(), h[0, n[0] - 1].numpy()) <= 1e-6


def test_recurrent_block_prefill_and_decode_match_jax(block):
    cfg, tcfg, jp, tp = block
    g = _gen("rg-block")
    B, S = 2, 32
    x = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    n = np.asarray([19, 32], np.int32)
    valid = np.arange(S)[None] < n[:, None]

    def ctx(mod):
        return dict(collect_cache=True, prompt_lengths=mod(n),
                    valid=mod(valid))
    jo, (jc, jh), _ = jax.jit(lambda p, x_: jrg.recurrent_block_apply(
        p, x_, cfg, ctx(jnp.asarray)))(jp, jnp.asarray(x))
    o, (c, hl), _ = rglru.recurrent_block_apply(tp, _t(x), tcfg, ctx(_t))
    assert rel(o.numpy(), jo) <= 1e-5
    assert rel(c.numpy(), jc) <= 1e-6
    assert rel(hl.numpy(), jh) <= 1e-5
    cache = layer(rglru.init_rglru_cache(tcfg, 1, B, "cpu"), 0)
    cache["conv"].copy_(c)
    cache["h"].copy_(hl)
    ptrs = [t.data_ptr() for t in cache.values()]
    jcache = dict(conv=jc, h=jh)
    step = jax.jit(lambda p, x_, c_: jrg.recurrent_block_apply(
        p, x_, cfg, {}, c_))
    for _ in range(4):
        x1 = g.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jo, jcache, _ = step(jp, jnp.asarray(x1), jcache)
        o, out, _ = rglru.recurrent_block_apply(tp, _t(x1), tcfg, {}, cache)
        assert out is cache
        assert rel(o.numpy(), jo) <= 1e-5
        assert rel(cache["h"].numpy(), jcache["h"]) <= 1e-5
        assert rel(cache["conv"].numpy(), jcache["conv"]) <= 1e-6
    assert [t.data_ptr() for t in cache.values()] == ptrs
    assert cache["h"].dtype == torch.float32


def test_gelu_is_jax_tanh_gelu():
    x = np.linspace(-12, 12, 20001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = layers.act_fn("gelu")(_t(x)).numpy()
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    # torch's default (exact erf) form differs by far more than that
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_windowed_attention_scores_match_jax(impl):
    """40 queries over 40 keys under a window of 16 (causal): equal to the
    reference's, and never the flash kernel op's path."""
    g = _gen(("win-attn", impl))
    B, S, H, KV, hd = 2, 40, 4, 1, 32
    q, k, v = (g.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = jlayers.attention_scores(*map(jnp.asarray, (q, k, v)),
                                    causal=True, q_pos=jnp.asarray(pos),
                                    k_pos=jnp.asarray(pos), window=16,
                                    impl=impl)
    got = layers.attention_scores(*map(_t, (q, k, v)), causal=True,
                                  q_pos=_t(pos), k_pos=_t(pos), window=16,
                                  impl=impl)
    assert rel(got.numpy(), want) <= 1e-5
    full = layers.attention_scores(*map(_t, (q, k, v)), causal=True,
                                   q_pos=_t(pos), k_pos=_t(pos))
    assert rel(got.numpy(), full.numpy()) > 1e-3      # the window bites


def test_windowed_ring_decode_across_a_wrap():
    """Twelve ``gqa_attention`` decode steps of the smoke attention block
    over a ring of ``window`` = 8 rows (``init_gqa_cache(window=)``) from
    positions 0, 3 and 6: every slot wraps; outputs and the written ring
    agree with the reference each step."""
    jp_all, npp = weights("rglru3")
    cfg, tcfg = configs("rglru3")
    jp = jax.tree.map(lambda v: jnp.asarray(v[0]), npp["pat"]["a2"]["attn"])
    tp = {k: torch.from_numpy(v[0].copy())
          for k, v in npp["pat"]["a2"]["attn"].items()}
    B, W = 3, 8
    jcache = jax.tree.map(lambda v: v[0],
                          jlayers.init_gqa_cache(cfg, 1, B, 64, window=W))
    cache = layer(layers.init_gqa_cache(tcfg, 1, B, 64, "cpu", window=W), 0)
    assert cache["k"].shape[1] == W == jcache["k"].shape[1]
    g = _gen("win-ring")
    pos = np.array([[0], [3], [6]], np.int32)
    for _ in range(12):
        x = g.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jlayers.gqa_attention(
            jp, jnp.asarray(x), cfg=cfg, positions=jnp.asarray(pos),
            cache=jcache, window=W)
        out, cache = layers.gqa_attention(
            tp, _t(x), cfg=tcfg, positions=_t(pos), cache=cache, window=W)
        assert rel(out.numpy(), jout) <= 1e-5
        pos = pos + 1
    for k in ("k", "v"):
        assert rel(cache[k].numpy(), jcache[k]) <= 1e-6
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_fp8_streams_equal_jax():
    check_fp8_streams("rglru3")
