"""PyTorch port: GQA attention (prefill and the paged decode step), its
paged K/V pool and the paged_gqa_decode kernel op against the JAX
reference (``repro.models.layers``, ``repro.kernels.paged_attention``).

Inputs come from numpy seeds; weights are the JAX ``Model.init`` tree of
qwen3-14b at smoke width (4 heads over 4 KV heads, hd 32, fp32) copied
through ``bridge.params_from_jax``. The ``grouped`` tests widen it to 10
heads over 2 KV heads, so that 5 query heads share a KV head as at full
width. The JAX kernel ops run on the CPU's default backend (the Pallas
kernels in interpret mode). Tolerance: 1e-5 of the largest reference
magnitude unless a test says otherwise.
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
from repro.kernels.paged_attention import ops as jpaged_ops
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import paged
from repro_torch.kernels import registry
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import layers
from repro_torch.models.api import Model
from repro_torch.serve.engine import Request, ServeEngine

from test_kernel_properties import (GOLDEN_GQA, GOLDEN_GQA_FP8,
                                    _golden_gqa_inputs)
from _torch_threads import one_thread  # noqa: F401


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
    err = float(np.abs(a - b).max())
    assert err <= rtol * max(float(np.abs(b).max()), 1e-30), err


def _bytes(q):
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.array(jax.lax.bitcast_convert_type(q, jnp.uint8))


def _to_jax(t):
    """A port pool leaf as the JAX package holds it (uint8 stays bytes)."""
    return jnp.asarray(t.numpy())


# 5 query heads per KV head, as qwen3-14b has at full width (40 over 8)
GROUPED = dict(num_heads=10, num_kv_heads=2)


def _models(**overrides):
    """Smoke qwen3-14b in both packages, with ``overrides``, one weight
    tree."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-14b")),
                              **overrides)
    tcfg = dataclasses.replace(tsmoke(tget("qwen3-14b")), **overrides)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def qwen():
    return _models()


@pytest.fixture(scope="module")
def qwen_grouped():
    return _models(**GROUPED)


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


def _jlayer0(tree):
    return jax.tree.map(lambda v: v[0], tree)


# --- kernel op -------------------------------------------------------------------

# (B, H, KV, hd, pool, page, pp) — the reference's paged_gqa_decode sweep
# (G = 4, 4, 1, 8); its "bf16" case keeps fp32 pools with unit scales
PAGED_CASES = [((2, 8, 2, 32, 12, 16, 4), "fp8"),
               ((2, 8, 2, 32, 12, 16, 4), "bf16"),
               ((1, 4, 4, 64, 8, 8, 6), "fp8"),
               ((3, 16, 2, 32, 24, 4, 8), "fp8")]


# qwen3-14b's decode on the main path: 40 heads over 8, hd 128, page 8,
# 256 pages a slot (2048 rows); and the sweep's shapes for the split plan
MAIN_GQA = (4, 40, 8, 128, 1024, 8, 256)
PLAN_CASES = list(dict.fromkeys(d for d, _ in PAGED_CASES))


def _paged_inputs(dims, storage):
    B, H, KV, hd, pool, page, pp = dims
    g = _gen(("gqa", dims, storage))
    q = g.standard_normal((B, H, hd)).astype(np.float32)
    k = torch.from_numpy(g.standard_normal(
        (pool + 1, page, KV, hd)).astype(np.float32))
    v = torch.from_numpy(g.standard_normal(
        (pool + 1, page, KV, hd)).astype(np.float32))
    if storage == "fp8":
        k, ks = paged.quantize_vecs(k, vec_ndim=2)
        v, vs = paged.quantize_vecs(v, vec_ndim=2)
    else:
        ks = torch.ones(pool + 1, page)
        vs = torch.ones(pool + 1, page)
    table = g.permutation(pool)[:B * pp].reshape(B, pp).astype(np.int32)
    qpos = (np.arange(B) * 3 + (pp * page) // 2).astype(np.int32)
    return q, k, v, ks, vs, table, qpos


class TestPagedGqaDecodeOp:
    @pytest.mark.parametrize("dims,storage", PAGED_CASES)
    def test_plain_matches_jax_interpret_kernel(self, dims, storage):
        q, k, v, ks, vs, table, qpos = _paged_inputs(dims, storage)

        def jpool(t):
            if storage != "fp8":
                return jnp.asarray(t.numpy())
            return jax.lax.bitcast_convert_type(jnp.asarray(_bytes(t)),
                                                jnp.float8_e4m3fn)
        ref = jpaged_ops.paged_gqa_decode(  # CPU default backend: interpret
            jnp.asarray(q), jpool(k), jpool(v), jnp.asarray(ks.numpy()),
            jnp.asarray(vs.numpy()), jnp.asarray(table), jnp.asarray(qpos),
            scale=0.13)
        pool = (lambda t: t.view(torch.uint8)) if storage == "fp8" else (
            lambda t: t)
        ours = paged_ops.paged_gqa_decode(
            torch.from_numpy(q), pool(k), pool(v), ks, vs,
            torch.from_numpy(table), torch.from_numpy(qpos), scale=0.13)
        _close(ours, ref)

    @pytest.mark.parametrize("fp8", [False, True])
    def test_golden(self, fp8):
        args = [torch.from_numpy(_bytes(a) if a.dtype == jnp.float8_e4m3fn
                                 else np.array(a))
                for a in _golden_gqa_inputs(fp8)]
        out = paged_ops.paged_gqa_decode(*args, scale=0.3)
        np.testing.assert_allclose(out.numpy(),
                                   GOLDEN_GQA_FP8 if fp8 else GOLDEN_GQA,
                                   rtol=1e-5, atol=1e-6)

    def test_unit_scales_may_be_omitted(self):
        q, k, v, ks, vs, table, qpos = _paged_inputs(PAGED_CASES[1][0],
                                                     "bf16")
        args = (torch.from_numpy(q), k, v)
        rest = (torch.from_numpy(table), torch.from_numpy(qpos))
        _close(paged_ops.paged_gqa_decode(*args, None, None, *rest,
                                          scale=0.13),
               paged_ops.paged_gqa_decode(*args, ks, vs, *rest, scale=0.13),
               rtol=0)
        qk, sk = paged.quantize_vecs(k, vec_ndim=2)
        with pytest.raises(ValueError, match="scales"):
            paged_ops.paged_gqa_decode(torch.from_numpy(q), qk.view(
                torch.uint8), qk.view(torch.uint8), None, None, *rest,
                scale=0.13)
        with pytest.raises(ValueError, match="both"):
            paged_ops.paged_gqa_decode(*args, ks, None, *rest, scale=0.13)

    @pytest.mark.parametrize("esize", [1, 2, 4])
    @pytest.mark.parametrize("dims", [MAIN_GQA] + PLAN_CASES)
    def test_split_plan_tiles_the_rows(self, dims, esize):
        """The split plan of an E4M3 (1 byte), bf16 (2) or fp32 (4) pool:
        whole pages, every row of a slot in exactly one split, none empty,
        the split's K and V rows within the kernel's shared memory, and a
        workspace of B*H*S accumulators of hd plus m and l."""
        B, H, KV, hd, _, page, pp = dims
        rps, S = paged_ops.gqa_split_plan(B, KV, hd, esize, page, pp, 132)
        rows = pp * page
        assert rps % page == 0 and rps >= page
        splits = [range(s * rps, min((s + 1) * rps, rows)) for s in range(S)]
        assert [t for r in splits for t in r] == list(range(rows))
        assert all(len(r) for r in splits)
        assert 2 * rps * paged_ops.gqa_row_stride(hd, esize) \
            <= paged_ops.GQA_KV_SMEM
        assert paged_ops.workspace_floats(B, H, S, hd) == (
            B * H * S * hd + 2 * B * H * S)

    @pytest.mark.parametrize("B,contexts,plan,active", [
        (4, (600, 900, 1200, 1500), (128, 16), 280),
        (1, (2048,), (64, 32), 256)])
    def test_split_plan_fills_the_card(self, B, contexts, plan, active):
        """qwen3-14b on 132 SMs: four slots at the bench's contexts get
        128-row splits, 512 CTAs of which 280 are active (two a SM); one
        slot at 2048 rows gets 64-row splits, 256 active (it had 8 CTAs
        before the split)."""
        assert paged_ops.gqa_split_plan(B, 8, 128, 1, 8, 256, 132) == plan
        assert 8 * sum(-(-c // plan[0]) for c in contexts) == active
        assert active >= 132

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    def test_plain_reads_a_pool_written_in_place(self, storage):
        """The plain version decodes the pools it is given on every call: a
        token written in place (``page_write``) into the same tensor
        objects changes the next output, which equals a call on fresh
        copies."""
        q, k, v, ks, vs, table, qpos = _paged_inputs(
            PAGED_CASES[0][0] if storage == "fp8" else PAGED_CASES[1][0],
            storage)
        k, v = ((t.view(torch.uint8) for t in (k, v))
                if storage == "fp8" else (k, v))
        q = torch.from_numpy(q)
        rest = (torch.from_numpy(table), torch.from_numpy(qpos))
        before = paged_ops.paged_gqa_decode(q, k, v, ks, vs, *rest,
                                            scale=0.13)
        g = _gen("rewrite")
        pos = torch.zeros(table.shape[0], dtype=torch.int32)
        for pool, spool in ((k, ks), (v, vs)):
            vals = 8 * torch.from_numpy(g.standard_normal(
                (table.shape[0],) + tuple(pool.shape[2:])).astype(np.float32))
            if storage == "fp8":
                vals, s = paged.quantize_vecs(vals, vec_ndim=2)
                paged.page_write(spool, rest[0], pos, s)
            paged.page_write(pool, rest[0], pos, vals)
        after = paged_ops.paged_gqa_decode(q, k, v, ks, vs, *rest,
                                           scale=0.13)
        fresh = paged_ops.paged_gqa_decode(q, k.clone(), v.clone(), ks, vs,
                                           *rest, scale=0.13)
        assert not torch.equal(after, before)
        _close(after, fresh, rtol=0)

    def test_cpu_runs_plain_and_counts_nothing(self):
        registry.reset_launch_counts()
        args = [torch.from_numpy(np.array(a))
                for a in _golden_gqa_inputs(False)]
        paged_ops.paged_gqa_decode(*args, scale=0.3)
        assert registry.launch_counts()["paged_gqa_decode"] == 0


# --- GQA layers --------------------------------------------------------------------


def _check_prefill(models, impl):
    """gqa_attention without a cache, and the (k, v) entries it
    returns, against the reference."""
    cfg, tcfg, jp, tp = models
    x = _gen(("prefill", impl)).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    jout, _ = jlayers.gqa_attention(
        _jlayer0(jp["blocks"]["attn"]), jnp.asarray(x), cfg=cfg,
        positions=jnp.asarray(pos), impl=impl)
    out, (k, v) = layers.gqa_attention(
        _layer0(tp["blocks"]["attn"]), torch.from_numpy(x), cfg=tcfg,
        positions=torch.from_numpy(pos), impl=impl,
        return_cache_entries=True)
    _close(out, jout)
    # the entries the reference recomputes for cache assembly
    # (transformer._self_attention under collect_cache)
    p0 = _jlayer0(jp["blocks"]["attn"])
    jk = jlayers._split_heads(jlayers.linear(jnp.asarray(x), p0["wk"]),
                              cfg.num_kv_heads)
    jk = jlayers.apply_rope(jlayers.rmsnorm(jk, p0["k_norm"], cfg.rms_eps),
                            jnp.asarray(pos), cfg.rope_theta)
    jv = jlayers._split_heads(jlayers.linear(jnp.asarray(x), p0["wv"]),
                              cfg.num_kv_heads)
    _close(k, jk)
    _close(v, jv)


def _check_paged_step(models, storage, impl, S=1):
    """One paged step of gqa_attention over S tokens a slot (S > 1: a
    chunked-prefill run) against the reference: the output and the pool
    rows it writes (at S > 1 the trash page aside: several rows of one run
    may land there, in an order neither package fixes)."""
    cfg, tcfg, jp, tp = models
    g = _gen(("step", storage, impl) if S == 1 else ("chunk", storage, impl))
    B, P, page, pp = 3, 9, 4, 3
    KV, hd = cfg.num_kv_heads, cfg.head_dim_()
    k = torch.from_numpy(g.standard_normal(
        (P + 1, page, KV, hd)).astype(np.float32))
    v = torch.from_numpy(g.standard_normal(
        (P + 1, page, KV, hd)).astype(np.float32))
    if storage == "fp8":
        qk, sk = paged.quantize_vecs(k, vec_ndim=2)
        qv, sv = paged.quantize_vecs(v, vec_ndim=2)
        tcache = dict(k=qk.view(torch.uint8).clone(),
                      v=qv.view(torch.uint8).clone(),
                      k_scale=sk, v_scale=sv)
    else:
        tcache = dict(k=k, v=v)
    jcache = {n: _to_jax(t) for n, t in tcache.items()}
    if S == 1:
        table = np.array([[0, 4, 9], [2, 1, 9], [9, 9, 9]], np.int32)
        pos = np.array([[6], [3], [5]], np.int32)
    else:     # page-aligned runs: after a resident page, in a fresh slot,
        # and into the trash page (a slot with no pages, output not held)
        table = np.array([[0, 4, 5], [2, 1, 6], [9, 9, 9]], np.int32)
        pos = np.array([4, 0, 0], np.int32)[:, None] + np.arange(S,
                                                                dtype=np.int32)
    x = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    # a run's T = 12 keys are no multiple of the Pallas kernel's key
    # block, so the reference's run attends through its ref backend
    with kernels.use_backend("ref" if S > 1 else kernels.active_backend(),
                             clear_caches=False):
        jout, jnew = jlayers.gqa_attention(
            _jlayer0(jp["blocks"]["attn"]), jnp.asarray(x), cfg=cfg,
            positions=jnp.asarray(pos), cache=jcache,
            page_table=jnp.asarray(table), impl=impl)
    out, new = layers.gqa_attention(
        _layer0(tp["blocks"]["attn"]), torch.from_numpy(x), cfg=tcfg,
        positions=torch.from_numpy(pos), cache=tcache,
        page_table=torch.from_numpy(table), impl=impl)
    live = B if S == 1 else 2         # the trash-page slot reads any bytes
    # at S = 1 every page, the trash page too, has one writer a row
    sl = slice(None) if S == 1 else slice(0, P)
    _close(out[:live], np.asarray(jout)[:live])
    assert new is tcache                      # written in place
    for n in new:        # the written token rows agree
        a, b = new[n], jnew[n]
        if a.dtype == torch.uint8:
            a, b = paged.e4m3_decode(a), paged.e4m3_decode(
                torch.from_numpy(_bytes(b)))
        _close(a[sl], np.asarray(b)[sl], rtol=1e-6)


class TestGqaAttention:
    def test_specs_match_reference(self, qwen):
        cfg, tcfg, _, _ = qwen
        ours = layers.gqa_specs(tcfg, 3)
        ref = jlayers.gqa_specs(cfg, 3)
        assert set(ours) == set(ref) == {"wq", "wk", "wv", "wo", "q_norm",
                                         "k_norm"}
        for k in ours:
            assert ours[k].shape == ref[k].shape
            assert ours[k].axes == ref[k].axes

    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_prefill_attention_and_entries(self, qwen, impl):
        _check_prefill(qwen, impl)

    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_grouped_prefill_attention_and_entries(self, qwen_grouped, impl):
        _check_prefill(qwen_grouped, impl)

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_paged_decode_step(self, qwen, storage, impl):
        _check_paged_step(qwen, storage, impl)

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_grouped_paged_decode_step(self, qwen_grouped, storage, impl):
        _check_paged_step(qwen_grouped, storage, impl)

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_paged_chunk_step(self, qwen, storage, impl):
        _check_paged_step(qwen, storage, impl, S=8)

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_grouped_paged_chunk_step(self, qwen_grouped, storage, impl):
        _check_paged_step(qwen_grouped, storage, impl, S=8)

    def test_unported_branches_raise(self, qwen):
        """An attention kind that is none of the reference's (MLA, GQA,
        local GQA: its enc-dec and vision families cross-attend through
        GQA) raises; a windowed ring (ported with the hybrid family) is the
        reference's ``window`` rows."""
        from repro_torch.models import transformer
        cfg, tcfg, _, _ = qwen
        with pytest.raises(ValueError, match="attention='cross'"):
            transformer.attn_specs(
                dataclasses.replace(tcfg, attention="cross"), 1)
        ours = layers.init_gqa_cache(tcfg, 1, 1, 16, "cpu", window=8)
        ref = jlayers.init_gqa_cache(cfg, 1, 1, 16, window=8)
        for n in ref:
            assert tuple(ours[n].shape) == ref[n].shape == (
                (1, 1, 8) + ref[n].shape[3:])

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    def test_paged_pool_matches_reference(self, qwen, storage):
        cfg, tcfg, _, _ = qwen
        ours = layers.init_paged_gqa_cache(tcfg, 2, 6, 8, storage, "cpu")
        ref = jlayers.init_paged_gqa_cache(cfg, 2, 6, 8, storage)
        assert set(ours) == set(ref)
        for n in ours:
            assert tuple(ours[n].shape) == ref[n].shape
            assert str(ours[n].dtype).split(".")[-1] == str(ref[n].dtype)


# --- Model, bridge -------------------------------------------------------------------


def test_bridge_carries_the_gqa_weights(qwen):
    cfg, tcfg, jp, tp = qwen
    attn = tp["blocks"]["attn"]
    assert set(attn) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    for n, t in attn.items():
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(jp["blocks"]["attn"][n]))
    ready = bridge.prepare_for_serving(tp, tcfg)     # fp8=False: as it is
    assert ready["prepared"] and ready["blocks"] is tp["blocks"]
    assert ready["blocks"]["attn"]["wq"] is attn["wq"]


@pytest.mark.parametrize("storage", ["fp8", "bf16"])
def test_prefill_to_pages_matches_reference(qwen, storage):
    """Prefill K/V rows through ``prefill_to_pages``: same leaves and page
    shapes as the reference; the values (dequantized under fp8) agree."""
    cfg, tcfg, jp, tp = qwen
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = np.arange(11) * 7 % cfg.vocab_size
    lengths = np.asarray([11], np.int32)
    jm = JModel(cfg)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                       lengths=jnp.asarray(lengths))
    jpay = jm.prefill_to_pages(jc, 8, storage)["pages"]["blocks"]
    tm = Model(tcfg, device="cpu")
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       lengths=lengths)
    assert tuple(tc["blocks"]["k"].shape) == jc["blocks"]["k"].shape
    assert (tc["blocks"]["pos"][0, 0, 11:] == -1).all()
    pay = tm.prefill_to_pages(tc, 8, storage)["pages"]["blocks"]
    assert set(pay) == set(jpay)
    for n in ("k", "v"):
        assert tuple(pay[n].shape) == jpay[n].shape
        if storage == "fp8":
            a = paged.dequantize_vecs(pay[n], pay[n + "_scale"], 2)
            b = paged.dequantize_vecs(torch.from_numpy(_bytes(jpay[n])),
                                      torch.from_numpy(np.array(
                                          jpay[n + "_scale"])), 2)
            _close(a, b, rtol=2 ** -3)     # one E4M3 step where a tie flips
            _close(pay[n + "_scale"], jpay[n + "_scale"])
        else:
            _close(pay[n], jpay[n])


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_grouped_streams_equal_jax_engine(qwen_grouped, storage,
                                          kernel_path):
    """The paged engine with 5 query heads per KV head: greedy streams
    equal the JAX ``ServeEngine``'s (its registry on the ``ref``
    backend), on the default path and on the kernel path."""
    cfg, tcfg, jp, _ = qwen_grouped
    kw = dict(slots=2, max_len=32, seed=0, chunk=4, paged=True, page_size=8,
              page_storage=storage, attn_impl="pallas" if kernel_path else "")
    prompts = [np.arange(4 + i * 3) * (i + 3) % cfg.vocab_size
               for i in range(3)]
    with kernels.use_backend("ref"):
        jeng = JServeEngine(cfg, params=jp, **kw)
        jreqs = [JRequest(i, p, max_new=6) for i, p in enumerate(prompts)]
        for r in jreqs:
            jeng.submit(r)
        jeng.run_until_done()
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(
        jax.tree.map(np.asarray, jp)), device="cpu", **kw)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert [list(r.out) for r in reqs] == [list(r.out) for r in jreqs]
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert eng.free_pages() == eng.pool_pages
