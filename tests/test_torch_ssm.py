"""PyTorch port: the Mamba-2 SSD block (``models/ssm.py``) against the
reference's functions (``repro.models.ssm``) on the same numpy inputs, at
smoke width in fp32.

* ``_causal_conv`` with and without a carried ``state`` and per-row
  ``lengths`` (one below K-1, so the tail reaches into the zero pad): the
  output and the tail within 1e-6 of the largest.
* ``_ssd_scan`` at chunks of 8 to 64 over 64 steps: the output and the
  final state within 1e-5 of the largest, and the same at every chunk.
* ``ssd_block_apply``: a bucket-padded prefill whose collected conv tail
  and state equal the unpadded prompt's (and the reference's), then decode
  steps on that state, written in place.
* mamba2's smoke config with ``fp8``: the dense engine's streams equal the
  JAX engine's.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_recurrent import check_fp8_streams, configs, rel, weights
from repro.models import ssm as jssm
from repro_torch.models import ssm
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


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("lengths", [None, (1, 9, 16)])
def test_causal_conv_matches_jax(with_state, lengths):
    g = _gen(("conv", with_state, lengths))
    B, S, C, K = 3, 16, 24, 4
    x = g.standard_normal((B, S, C)).astype(np.float32)
    w = g.standard_normal((K, C)).astype(np.float32)
    b = g.standard_normal((C,)).astype(np.float32)
    st = (g.standard_normal((B, K - 1, C)).astype(np.float32)
          if with_state else None)
    n = None if lengths is None else np.asarray(lengths, np.int32)
    jo, jt = jssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st),
        None if n is None else jnp.asarray(n))
    o, t = ssm._causal_conv(_t(x), _t(w), _t(b),
                            None if st is None else _t(st),
                            None if n is None else _t(n))
    assert rel(o.numpy(), jo) <= 1e-6
    assert rel(t.numpy(), jt) <= 1e-6
    if n is not None and not with_state:
        # a 1-token prompt's tail: two zero pad rows, then its token
        np.testing.assert_array_equal(t[0, :2].numpy(), 0)
        np.testing.assert_array_equal(t[0, 2].numpy(), x[0, 0])


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_scan_matches_jax(chunk):
    g = _gen("ssd-scan")
    B, S, H, P, N = 2, 64, 4, 8, 16
    x = g.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(g.standard_normal((H,)) * 0.5).astype(np.float32)
    Bm = g.standard_normal((B, S, N)).astype(np.float32)
    Cm = g.standard_normal((B, S, N)).astype(np.float32)
    jy, js = jax.jit(jssm._ssd_scan, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    y, st = ssm._ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    assert y.dtype == st.dtype == torch.float32
    assert rel(y.numpy(), jy) <= 1e-5
    assert rel(st.numpy(), js) <= 1e-5
    # the decomposition is exact: every chunking gives the whole-sequence
    # result
    y1, s1 = ssm._ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), S)
    assert rel(y.numpy(), y1.numpy()) <= 1e-5
    assert rel(st.numpy(), s1.numpy()) <= 1e-5


def test_ssd_block_prefill_and_decode_match_jax():
    """Row 0 is 21 real tokens in a 32-wide bucket, row 1 32: the collected
    tail and state equal the reference's and, for row 0, those of the
    21-token prompt alone; then four decode steps on them."""
    jp_all, npp = weights("mamba2")
    cfg, tcfg = configs("mamba2")
    jp = jax.tree.map(lambda v: v[0], jp_all["blocks"])
    tp = {k: torch.from_numpy(v[0].copy()) for k, v in npp["blocks"].items()}
    g = _gen("ssd-block")
    B, S, d = 2, 32, cfg.d_model
    x = g.standard_normal((B, S, d)).astype(np.float32)
    n = np.asarray([21, 32], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    valid = pos < n[:, None]

    def ctx(mod, lengths, v):
        return dict(collect_cache=True, prompt_lengths=mod(lengths),
                    valid=mod(v))
    jo, (jc, js), _ = jax.jit(lambda p, x_: jssm.ssd_block_apply(
        p, x_, cfg, ctx(jnp.asarray, n, valid)))(jp, jnp.asarray(x))
    o, (c, s), _ = ssm.ssd_block_apply(tp, _t(x), tcfg,
                                       ctx(_t, n, valid))
    assert rel(o.numpy(), jo) <= 1e-5
    assert rel(c.numpy(), jc) <= 1e-6
    assert rel(s.numpy(), js) <= 1e-5
    # the padded row's cache is the unpadded prompt's
    L = int(n[0])
    x0 = np.ascontiguousarray(x[:1, :L])
    o1, (c1, s1), _ = ssm.ssd_block_apply(
        tp, _t(x0), tcfg, dict(collect_cache=True,
                               prompt_lengths=_t(np.asarray([L], np.int32)),
                               valid=_t(np.ones((1, L), bool))))
    assert rel(c[:1].numpy(), c1.numpy()) <= 1e-6
    assert rel(s[:1].numpy(), s1.numpy()) <= 1e-5
    assert rel(o[:1, :L].numpy(), o1.numpy()) <= 1e-5
    # decode on the collected state, written in place
    cache = layer(ssm.init_ssd_cache(tcfg, 1, B, "cpu"), 0)
    cache["conv"].copy_(c)
    cache["state"].copy_(s)
    ptrs = [t.data_ptr() for t in cache.values()]
    jcache = dict(conv=jc, state=js)
    step = jax.jit(lambda p, x_, c_: jssm.ssd_block_apply(p, x_, cfg, {},
                                                          c_))
    for _ in range(4):
        x1 = g.standard_normal((B, 1, d)).astype(np.float32)
        jo, jcache, _ = step(jp, jnp.asarray(x1), jcache)
        o, out, _ = ssm.ssd_block_apply(tp, _t(x1), tcfg, {}, cache)
        assert out is cache
        assert rel(o.numpy(), jo) <= 1e-5
        assert rel(cache["state"].numpy(), jcache["state"]) <= 1e-5
        assert rel(cache["conv"].numpy(), jcache["conv"]) <= 1e-6
    assert [t.data_ptr() for t in cache.values()] == ptrs
    assert cache["state"].dtype == torch.float32


def test_fp8_streams_equal_jax():
    check_fp8_streams("mamba2")
