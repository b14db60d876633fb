"""PyTorch port: paged E4M3 latent pool, MLA prefill/decode and the
paged_mla_decode kernel op against the JAX reference (``repro.core.paged``,
``repro.core.mla``, ``repro.kernels.paged_attention``).

Inputs come from numpy seeds; weights are the JAX ``Model.init`` tree
copied through ``bridge.params_from_jax``. Tolerances are fp32 (1e-5 of
the largest reference magnitude) unless a test says otherwise.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, smoke_config
from repro.core import mla as jmla
from repro.core import paged as jpaged
from repro.kernels.paged_attention import ops as jpaged_ops
from repro.models.api import Model as JModel
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import mla, paged
from repro_torch.kernels import registry
from repro_torch.kernels.paged_attention import ops as paged_ops

from test_kernel_properties import GOLDEN_MLA, _golden_mla_inputs

RTOL = 1e-5


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rtol * scale, f"max err {err} > {rtol} x {scale}"


def _bytes(q):
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(q, jnp.uint8))


def _jax_e4m3(q):
    return jax.lax.bitcast_convert_type(jnp.asarray(_bytes(q)), jpaged.E4M3)


@pytest.fixture(scope="module")
def dsv3():
    """Smoke DeepSeek-V3 in both packages, one weight tree."""
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, tcfg, jp, tp


# --- kernel op ----------------------------------------------------------------

# (B, H, R, Rr, pool, page, pp) — the reference's paged_mla_decode sweep
PAGED_CASES = [((2, 8, 64, 16, 12, 16, 4), "fp8"),
               ((2, 8, 64, 16, 12, 16, 4), "bf16"),
               ((1, 4, 128, 32, 8, 8, 6), "fp8"),
               ((3, 16, 32, 8, 24, 4, 8), "fp8")]


def _paged_inputs(dims, storage):
    B, H, R, Rr, pool, page, pp = dims
    g = _gen(("paged", dims, storage))
    qa = g.standard_normal((B, H, R)).astype(np.float32)
    qr = g.standard_normal((B, H, Rr)).astype(np.float32)
    ckv = torch.from_numpy(g.standard_normal((pool + 1, page, R)).astype(np.float32))
    kr = torch.from_numpy(g.standard_normal((pool + 1, page, Rr)).astype(np.float32))
    if storage == "fp8":
        ckv, cs = paged.quantize_vecs(ckv)
        kr, ks = paged.quantize_vecs(kr)
    else:
        cs = torch.ones(pool + 1, page)
        ks = torch.ones(pool + 1, page)
    table = g.permutation(pool)[:B * pp].reshape(B, pp).astype(np.int32)
    qpos = (np.arange(B) * 3 + (pp * page) // 2).astype(np.int32)
    return qa, qr, ckv, kr, cs, ks, table, qpos


class TestPagedMlaDecodeOp:
    @pytest.mark.parametrize("dims,storage", PAGED_CASES)
    def test_plain_matches_jax_interpret_kernel(self, dims, storage):
        qa, qr, ckv, kr, cs, ks, table, qpos = _paged_inputs(dims, storage)
        jckv = _jax_e4m3(ckv) if storage == "fp8" else jnp.asarray(ckv.numpy())
        jkr = _jax_e4m3(kr) if storage == "fp8" else jnp.asarray(kr.numpy())
        ref = jpaged_ops.paged_mla_decode(  # CPU default backend: interpret
            jnp.asarray(qa), jnp.asarray(qr), jckv, jkr,
            jnp.asarray(cs.numpy()), jnp.asarray(ks.numpy()),
            jnp.asarray(table), jnp.asarray(qpos), scale=0.11)
        pool = (lambda t: t.view(torch.uint8)) if storage == "fp8" else (
            lambda t: t)
        ours = paged_ops.paged_mla_decode(
            torch.from_numpy(qa), torch.from_numpy(qr), pool(ckv), pool(kr),
            cs, ks, torch.from_numpy(table), torch.from_numpy(qpos),
            scale=0.11)
        _close(ours, ref)

    def test_golden(self):
        args = [torch.from_numpy(np.array(a)) for a in _golden_mla_inputs()]
        out = paged_ops.paged_mla_decode(*args, scale=0.25)
        np.testing.assert_allclose(out.numpy(), GOLDEN_MLA, rtol=1e-5,
                                   atol=1e-6)

    def test_cpu_runs_plain_and_counts_nothing(self):
        registry.reset_launch_counts()
        args = [torch.from_numpy(np.array(a)) for a in _golden_mla_inputs()]
        paged_ops.paged_mla_decode(*args, scale=0.25)
        assert registry.launch_counts()["paged_mla_decode"] == 0


# --- page primitives ------------------------------------------------------------


class TestPagePrimitives:
    def test_page_write_then_gather_dequant(self):
        g = _gen("pw")
        P1, page, R, B, pp = 7, 4, 16, 3, 2
        pool = np.zeros((P1, page, R), np.uint8)
        spool = np.zeros((P1, page), np.float32)
        table = np.array([[0, 2], [1, 6], [6, 6]], np.int32)   # 6 = trash
        pos = np.array([5, 2, 3], np.int32)
        vals = g.standard_normal((B, R)).astype(np.float32)
        q, s = paged.quantize_vecs(torch.from_numpy(vals))
        jq, js = jpaged.quantize_vecs(jnp.asarray(vals))
        tpool = paged.page_write(torch.from_numpy(pool.copy()),
                                 torch.from_numpy(table),
                                 torch.from_numpy(pos), q)
        tsp = paged.page_write(torch.from_numpy(spool.copy()),
                               torch.from_numpy(table),
                               torch.from_numpy(pos), s)
        jpool = jpaged.page_write(jnp.asarray(pool), jnp.asarray(table),
                                  jnp.asarray(pos), jq)
        jsp = jpaged.page_write(jnp.asarray(spool), jnp.asarray(table),
                                jnp.asarray(pos), js)
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
        t = torch.from_numpy(table)
        np.testing.assert_array_equal(
            paged.gather_dequant(tpool, tsp, t).numpy(),
            np.asarray(jpaged.gather_dequant(jpool, jsp, jnp.asarray(table))))
        np.testing.assert_array_equal(
            paged.table_gather(tpool, t).numpy(),
            np.asarray(jpaged.table_gather(jpool, jnp.asarray(table))))

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    def test_entries_to_pages_and_scatter(self, storage):
        g = _gen(("e2p", storage))
        leaf = g.standard_normal((2, 1, 16, 8)).astype(np.float32)
        leaf[:, :, 11:] = 0.0                     # pad rows
        ours = paged.entries_to_pages(torch.from_numpy(leaf), 4, storage,
                                      torch.float32)
        ref = jpaged.entries_to_pages(jnp.asarray(leaf), 4, storage,
                                      jnp.float32)
        assert set(ours) == set(ref)
        if storage == "fp8":
            np.testing.assert_array_equal(_bytes(ours["q"]),
                                          _bytes(ref["q"]))
            np.testing.assert_array_equal(ours["scale"].numpy(),
                                          np.asarray(ref["scale"]))
        ids = np.array([3, 0, 5, 5], np.int32)    # 5 = trash, twice
        dt = np.uint8 if storage == "fp8" else np.float32
        pool = np.zeros((2, 6, 4, 8), dt)
        tp = paged.scatter_pages(torch.from_numpy(pool.copy()), ours["q"],
                                 torch.from_numpy(ids))
        jp = jpaged.scatter_pages(jnp.asarray(pool), ref["q"],
                                  jnp.asarray(ids))
        np.testing.assert_array_equal(tp.numpy()[:, :5], np.asarray(jp)[:, :5])

    def test_allocator_recycles(self):
        a = paged.PrefixPageAllocator(6)
        ids = a.alloc(4)
        assert a.free_pages() == 2
        with pytest.raises(RuntimeError):
            a.alloc(3)
        a.release(ids)
        assert a.free_pages() == 6
        assert paged.pages_for(17, 8) == 3 and paged.trash_page(6) == 6


# --- MLA layers ---------------------------------------------------------------------


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


class TestMla:
    def test_prefill_attention_and_entries(self, dsv3):
        cfg, tcfg, jp, tp = dsv3
        x = _gen("prefill").standard_normal((2, 12, cfg.d_model)).astype(
            np.float32)
        pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
        jout, (jckv, jkr) = jmla.mla_attention(
            jax.tree.map(lambda v: v[0], jp["dense0"]["attn"]),
            jnp.asarray(x), cfg=cfg, positions=jnp.asarray(pos),
            return_cache_entries=True)
        out, (ckv, kr) = mla.mla_attention(
            _layer0(tp["dense0"]["attn"]), torch.from_numpy(x), cfg=tcfg,
            positions=torch.from_numpy(pos.copy()),
            return_cache_entries=True)
        _close(out, jout)
        _close(ckv, jckv)
        _close(kr, jkr)

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_paged_decode_step(self, dsv3, storage, impl):
        cfg, tcfg, jp, tp = dsv3
        g = _gen(("step", storage, impl))
        B, P, page, pp = 3, 9, 4, 3
        R, Rr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_dim
        ckv = torch.from_numpy(g.standard_normal((P + 1, page, R)).astype(np.float32))
        kr = torch.from_numpy(g.standard_normal((P + 1, page, Rr)).astype(np.float32))
        if storage == "fp8":
            qc, sc = paged.quantize_vecs(ckv)
            qk, sk = paged.quantize_vecs(kr)
            tcache = dict(ckv=qc.view(torch.uint8).clone(),
                          kr=qk.view(torch.uint8).clone(),
                          ckv_scale=sc, kr_scale=sk)
        else:
            tcache = dict(ckv=ckv, kr=kr)
        jcache = {k: jnp.asarray(v.numpy()) for k, v in tcache.items()}
        table = np.array([[0, 4, 9], [2, 1, 9], [9, 9, 9]], np.int32)
        pos = np.array([[6], [3], [5]], np.int32)
        x = g.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jout, jnew = jmla.mla_paged_decode_step(
            jax.tree.map(lambda v: v[0], jp["dense0"]["attn"]),
            jcache, jnp.asarray(x), cfg=cfg, positions=jnp.asarray(pos),
            page_table=jnp.asarray(table), impl=impl)
        out, new = mla.mla_paged_decode_step(
            _layer0(tp["dense0"]["attn"]), tcache, torch.from_numpy(x),
            cfg=tcfg, positions=torch.from_numpy(pos),
            page_table=torch.from_numpy(table), impl=impl)
        _close(out, jout)
        for k in new:      # the written token rows agree
            _close(paged.e4m3_decode(new[k]) if new[k].dtype == torch.uint8
                   else new[k],
                   jpaged.e4m3_decode(jnew[k]) if jnew[k].dtype == jnp.uint8
                   else jnew[k], rtol=1e-6)

    def test_decode_step_rejects_multi_token_runs(self, dsv3):
        cfg, tcfg, jp, tp = dsv3
        cache = mla.init_paged_mla_cache(tcfg, 1, 4, 4, "fp8", "cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mla.mla_paged_decode_step(
                _layer0(tp["dense0"]["attn"]), _layer0(cache),
                torch.zeros(1, 2, tcfg.d_model), cfg=tcfg,
                positions=torch.zeros(1, 2, dtype=torch.int32),
                page_table=torch.zeros(1, 1, dtype=torch.int32))

    def test_kv_bytes_per_token_table1(self):
        cfg = tget("deepseek-v3-671b")
        assert mla.kv_bytes_per_token(cfg, storage="bf16") == 70272
        assert mla.kv_bytes_per_token(cfg, storage="fp8") == 35624
        assert mla.kv_bytes_per_token(cfg) == jmla.kv_bytes_per_token(
            get_config("deepseek-v3-671b"))
