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


# DeepSeek-V3's decode on the main path: 128 heads, R 512, Rr 64, page 8,
# 128 pages a slot (1024 rows); and the sweep's shapes for the split plan
MAIN_MLA = (4, 128, 512, 64, 512, 8, 128)
PLAN_CASES = list(dict.fromkeys(d for d, _ in PAGED_CASES))


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

    def test_unit_scales_may_be_omitted(self):
        """Native pools take ``None`` scales, which equal explicit unit
        scales bit for bit; E4M3 pools without scales, and one scale
        without the other, raise."""
        qa, qr, ckv, kr, cs, ks, table, qpos = _paged_inputs(
            PAGED_CASES[1][0], "bf16")
        args = (torch.from_numpy(qa), torch.from_numpy(qr), ckv, kr)
        rest = (torch.from_numpy(table), torch.from_numpy(qpos))
        _close(paged_ops.paged_mla_decode(*args, None, None, *rest,
                                          scale=0.11),
               paged_ops.paged_mla_decode(*args, cs, ks, *rest, scale=0.11),
               rtol=0)
        codes = [paged.quantize_vecs(t)[0].view(torch.uint8)
                 for t in (ckv, kr)]
        with pytest.raises(ValueError, match="scales"):
            paged_ops.paged_mla_decode(*args[:2], *codes, None, None, *rest,
                                       scale=0.11)
        with pytest.raises(ValueError, match="both"):
            paged_ops.paged_mla_decode(*args, cs, None, *rest, scale=0.11)

    @pytest.mark.parametrize("dims", [MAIN_MLA] + PLAN_CASES)
    def test_split_plan_tiles_the_rows(self, dims):
        """The split plan: whole pages, every row of a slot in exactly one
        split, none empty, and a workspace of B*H*S accumulators of R plus
        m and l."""
        B, H, R, _, _, page, pp = dims
        rps, S = paged_ops.mla_split_plan(B, H, page, pp, 132)
        rows = pp * page
        assert rps % page == 0 and rps >= page
        splits = [range(s * rps, min((s + 1) * rps, rows)) for s in range(S)]
        assert [t for r in splits for t in r] == list(range(rows))
        assert all(len(r) for r in splits)
        assert paged_ops.workspace_floats(B, H, S, R) == (
            B * H * S * R + 2 * B * H * S)

    @pytest.mark.parametrize("B,contexts,plan,active", [
        (4, (64, 300, 700, 1024), (64, 16), 264),
        (1, (1024,), (64, 16), 128)])
    def test_split_plan_fills_the_card(self, B, contexts, plan, active):
        """DeepSeek-V3 on 132 SMs, CTAs of 16 heads (8 groups of 128): four
        slots at contexts 64-1024 get 64-row splits, 512 CTAs of which 264
        are active (two waves of one CTA a SM; it had 64 CTAs before the
        split); one slot at 1024 rows gets 128 active (it had 16)."""
        assert paged_ops.mla_split_plan(B, 128, 8, 128, 132) == plan
        assert 8 * sum(-(-c // plan[0]) for c in contexts) == active
        assert active >= 128

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    def test_plain_reads_a_pool_written_in_place(self, storage):
        """The plain version decodes the pool it is given on every call: a
        token written in place (``page_write``) into the same tensor object
        changes the next output, which equals a call on a fresh copy."""
        qa, qr, ckv, kr, cs, ks, table, qpos = _paged_inputs(
            PAGED_CASES[0][0] if storage == "fp8" else PAGED_CASES[1][0],
            storage)
        ckv, kr = ((t.view(torch.uint8) for t in (ckv, kr))
                   if storage == "fp8" else (ckv, kr))
        q = (torch.from_numpy(qa), torch.from_numpy(qr))
        rest = (torch.from_numpy(table), torch.from_numpy(qpos))
        before = paged_ops.paged_mla_decode(*q, ckv, kr, cs, ks, *rest,
                                            scale=0.11)
        vals = 8 * torch.from_numpy(_gen("rewrite").standard_normal(
            (table.shape[0], ckv.shape[-1])).astype(np.float32))
        pos = torch.zeros(table.shape[0], dtype=torch.int32)
        if storage == "fp8":
            vals, s = paged.quantize_vecs(vals)
            paged.page_write(cs, rest[0], pos, s)
        paged.page_write(ckv, rest[0], pos, vals)
        after = paged_ops.paged_mla_decode(*q, ckv, kr, cs, ks, *rest,
                                           scale=0.11)
        fresh = paged_ops.paged_mla_decode(*q, ckv.clone(), kr.clone(), cs,
                                           ks, *rest, scale=0.11)
        assert not torch.equal(after, before)
        _close(after, fresh, rtol=0)

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
    def test_page_write_chunk_matches_reference(self, storage):
        """Runs of two pages: whole pages into the slot's pages, a slot
        without pages into the trash page; every page but the trash page
        equals the reference's. A run that overhangs the table lands its
        overhang in the trash page (the reference clamps it onto the
        slot's last page, over rows the slot wrote)."""
        g = _gen(("pwc", storage))
        P1, page, R, B, C = 9, 4, 16, 3, 8
        table = np.array([[0, 2, 5], [1, 3, 7], [8, 8, 8]], np.int32)
        start = np.array([4, 0, 0], np.int32)
        vals = g.standard_normal((B, C, R)).astype(np.float32)
        if storage == "fp8":
            pool = np.zeros((P1, page, R), np.uint8)
            q, _ = paged.quantize_vecs(torch.from_numpy(vals))
            jq, _ = jpaged.quantize_vecs(jnp.asarray(vals))
        else:
            pool = np.zeros((P1, page, R), np.float32)
            q, jq = torch.from_numpy(vals), jnp.asarray(vals)
        ours = paged.page_write_chunk(torch.from_numpy(pool.copy()),
                                      torch.from_numpy(table),
                                      torch.from_numpy(start), q)
        ref = jpaged.page_write_chunk(jnp.asarray(pool), jnp.asarray(table),
                                      jnp.asarray(start), jq)
        np.testing.assert_array_equal(ours.numpy()[:-1], np.asarray(ref)[:-1])
        assert ours.numpy()[[2, 5, 1, 3]].any()
        # positions 8-15 of a 3-page table: the overhang goes to trash
        ours = paged.page_write_chunk(ours, torch.from_numpy(table),
                                      torch.from_numpy(start + 4), q)
        np.testing.assert_array_equal(ours[5],
                                      paged._to_store(ours, q)[0, :page])
        # the reference clamps the overhang (positions 12-15) onto the
        # slot's last page, over positions 8-11 (ROADMAP.md §C)
        ref = jpaged.page_write_chunk(ref, jnp.asarray(table),
                                      jnp.asarray(start + 4), jq)
        np.testing.assert_array_equal(
            np.asarray(ref)[5], paged._to_store(ours, q)[0, page:].numpy())

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


def _check_mla_step(dsv3, storage, impl, S):
    """One paged step of ``mla_paged_decode_step`` over S tokens a slot
    against the reference: the output and every pool page it writes (at S > 1
    the trash page aside: several rows of one run may land there, in an
    order neither package fixes)."""
    cfg, tcfg, jp, tp = dsv3
    g = _gen(("step", storage, impl) if S == 1 else ("chunk", storage, impl))
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
    if S == 1:
        table = np.array([[0, 4, 9], [2, 1, 9], [9, 9, 9]], np.int32)
        pos = np.array([[6], [3], [5]], np.int32)
    else:     # page-aligned runs: after a resident page, in a fresh slot,
        # and into the trash page (a slot with no pages, output not held)
        table = np.array([[0, 4, 5], [2, 1, 6], [9, 9, 9]], np.int32)
        pos = np.array([4, 0, 0], np.int32)[:, None] + np.arange(S,
                                                                dtype=np.int32)
    x = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jout, jnew = jmla.mla_paged_decode_step(
        jax.tree.map(lambda v: v[0], jp["dense0"]["attn"]),
        jcache, jnp.asarray(x), cfg=cfg, positions=jnp.asarray(pos),
        page_table=jnp.asarray(table), impl=impl)
    out, new = mla.mla_paged_decode_step(
        _layer0(tp["dense0"]["attn"]), tcache, torch.from_numpy(x),
        cfg=tcfg, positions=torch.from_numpy(pos),
        page_table=torch.from_numpy(table), impl=impl)
    live = B if S == 1 else 2         # the trash-page slot reads any bytes
    # at S = 1 every page, the trash page too, has one writer a row
    sl = slice(None) if S == 1 else slice(0, P)
    _close(out[:live], np.asarray(jout)[:live])
    for k in new:      # the written token rows agree
        a = (paged.e4m3_decode(new[k]) if new[k].dtype == torch.uint8
             else new[k])
        b = (jpaged.e4m3_decode(jnew[k]) if jnew[k].dtype == jnp.uint8
             else jnew[k])
        _close(a[sl], np.asarray(b)[sl], rtol=1e-6)


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
        _check_mla_step(dsv3, storage, impl, S=1)

    @pytest.mark.parametrize("storage", ["fp8", "bf16"])
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_paged_chunk_step(self, dsv3, storage, impl):
        """A chunked-prefill run of S = 8 tokens (two pages) per slot."""
        _check_mla_step(dsv3, storage, impl, S=8)

    def test_chunk_step_never_reaches_the_decode_kernel(self, dsv3,
                                                        monkeypatch):
        """The kernel stays single-token: on ``impl="pallas"`` a run of S > 1
        tokens never reaches the ``paged_mla_decode`` op and takes the
        gathered pages, as the reference's does."""
        calls = []
        op = registry.get("paged_mla_decode")
        plain = op._plain
        monkeypatch.setattr(op, "_plain",
                            lambda *a, **k: calls.append(1) or plain(*a, **k))
        _check_mla_step(dsv3, "fp8", "pallas", S=8)
        assert not calls
        _check_mla_step(dsv3, "fp8", "pallas", S=1)
        assert calls

    def test_kv_bytes_per_token_table1(self):
        cfg = tget("deepseek-v3-671b")
        assert mla.kv_bytes_per_token(cfg, storage="bf16") == 70272
        assert mla.kv_bytes_per_token(cfg, storage="fp8") == 35624
        assert mla.kv_bytes_per_token(cfg) == jmla.kv_bytes_per_token(
            get_config("deepseek-v3-671b"))
