"""PyTorch port: the continuous-batching scheduler of the paged engine
(chunked prefill interleaved with decode, priority preemption with
continuations, copy-on-write prefix sharing, ``cancel``) against the JAX
``ServeEngine`` on the same weights (``bridge.params_from_jax``).

Each scenario runs once on the JAX engine (its registry's ``ref`` backend)
and once on the port's, and the two must agree exactly: greedy streams,
free pages, ``prefix_stats()`` and every ``stats`` key both keep but
``dispatches``, which the port counts its own way. Smoke qwen3-14b with
bf16 pages and page 8, as ``tests/test_scheduler.py`` runs it; smoke
DeepSeek-V3 (MLA, MoE, MTP leaves) on bf16 and fp8 pages for the MLA
chunk and ``mtp_h``. The kernel path (``attn_impl="pallas"``) runs the
ops' plain versions here, on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models.api import Model
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_thread  # noqa: F401

POOL = 24


@pytest.fixture(scope="module")
def qwen():
    cfg = smoke_config(get_config("qwen3-14b"))
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jp, tsmoke(tget("qwen3-14b")), tp


def _prompt(rng, n):
    return rng.integers(1, 500, size=n).astype(np.int32)


class Side:
    """One engine family: the JAX reference or the port, with the smoke
    qwen3-14b weights both share."""

    def __init__(self, port, cfg, params, attn_impl=""):
        self.port, self.cfg, self.params = port, cfg, params
        self.attn_impl = attn_impl
        self.Request = Request if port else JRequest

    def engine(self, *, pool=POOL, slots=2, max_len=64, prefill_chunk=8,
               **kw):
        cls = ServeEngine if self.port else JServeEngine
        extra = dict(device="cpu") if self.port else {}
        return cls(self.cfg, params=self.params, slots=slots,
                   max_len=max_len, seed=0, chunk=4, paged=True, page_size=8,
                   pool_pages=pool, page_storage="bf16",
                   prefill_chunk=prefill_chunk, attn_impl=self.attn_impl,
                   **extra, **kw)


def _summary(eng, reqs):
    """What both engines must agree on after a scenario."""
    stats = {k: v for k, v in eng.stats.items() if k != "dispatches"}
    return dict(streams=[list(r.out) for r in reqs],
                done=[r.done for r in reqs], free=eng.free_pages(),
                prefix=eng.prefix_stats(), stats=stats)


def _both(qwen, scenario, attn_impl=""):
    """Run ``scenario(side)`` on the JAX engine and on the port; both
    summaries must be equal. Returns the port's."""
    cfg, jp, tcfg, tp = qwen
    with kernels.use_backend("ref"):
        ref = scenario(Side(False, cfg, jp, attn_impl))
    ours = scenario(Side(True, tcfg, tp, attn_impl))
    assert ours == ref
    return ours


# --- chunked prefill ---------------------------------------------------------


def _streams(side, pc):
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng, n) for n in (21, 13, 34)]
    eng = side.engine(prefill_chunk=pc)
    reqs = [side.Request(i, p, max_new=8, seed=5 + i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert eng.free_pages() == POOL                  # every page back
    return _summary(eng, reqs)


@pytest.fixture(scope="module")
def jax_streams(qwen):
    """The JAX engine's chunked runs, chunk 8 and 16, on its default path
    (its kernel path gives the same streams and counts: the reference's
    own tests hold them equal), once for the module."""
    cfg, jp, _, _ = qwen
    with kernels.use_backend("ref"):
        return {pc: _streams(Side(False, cfg, jp), pc) for pc in (8, 16)}


@pytest.mark.parametrize("attn_impl", ["", "pallas"], ids=["default",
                                                           "kernel"])
@pytest.mark.parametrize("pc", [8, 16])
def test_chunked_streams_equal_whole_prompt_and_jax(qwen, jax_streams, pc,
                                                    attn_impl):
    """Streaming the prompt in page-aligned chunks gives the whole-prompt
    (bucketed) prefill's streams bitwise, and the JAX engine's."""
    _, _, tcfg, tp = qwen
    chunked = _streams(Side(True, tcfg, tp, attn_impl), pc)
    assert chunked == jax_streams[pc]
    whole = _streams(Side(True, tcfg, tp, attn_impl), None)
    assert chunked["streams"] == whole["streams"]
    assert chunked["stats"]["chunk_prefills"] >= 6
    assert whole["stats"]["chunk_prefills"] == 0


def test_a_last_chunk_past_max_len_keeps_the_prompt(qwen):
    """Page 8, chunk 16, ``max_len`` 72 (9 pages) and a 68-token prompt:
    the last chunk (positions 64-79) runs past ``max_len``, and the prompt
    reaches into the slot's last page (64-71). The port sends the chunk's
    tenth page (72-79) to the trash page, so its chunked stream equals its
    own whole-prompt stream and the reference's. The reference clamps that
    page onto the slot's last page, over prompt rows 64-67, and its chunked
    stream differs from its whole-prompt one (ROADMAP.md §C)."""
    cfg, jp, tcfg, tp = qwen
    p = _prompt(np.random.default_rng(4), 68)

    def run(side, pc):
        eng = side.engine(max_len=72, prefill_chunk=pc)
        r = side.Request(0, p, max_new=4, seed=3)
        eng.submit(r)
        eng.run_until_done()
        assert r.done and eng.free_pages() == POOL
        return r.out
    ours = run(Side(True, tcfg, tp), 16)
    with kernels.use_backend("ref"):
        ref_whole = run(Side(False, cfg, jp), None)
        ref_chunked = run(Side(False, cfg, jp), 16)
    assert ours == run(Side(True, tcfg, tp), None) == ref_whole
    assert ref_chunked != ref_whole


def _interleave(side):
    rng = np.random.default_rng(5)
    eng = side.engine()
    resident = side.Request(0, _prompt(rng, 9), max_new=40, seed=1)
    eng.submit(resident)
    eng.step()
    long = side.Request(1, _prompt(rng, 48), max_new=8, seed=2)
    eng.submit(long)
    while eng._prefilling:
        before = len(resident.out)
        eng.step()
        if eng._prefilling and resident.out and not resident.done:
            assert len(resident.out) > before   # a chunk ran and it decoded
    assert eng.stats["chunk_prefills"] == 2 + 6  # 9 and 48 tokens, 8 a chunk
    eng.run_until_done()
    return _summary(eng, [resident, long])


def test_resident_decodes_every_tick_while_a_prompt_streams(qwen):
    out = _both(qwen, _interleave)
    assert all(out["done"])


# --- prefix sharing ----------------------------------------------------------


def _shared_prompts():
    rng = np.random.default_rng(7)
    prefix = _prompt(rng, 16)                        # 2 full pages
    tails = [_prompt(rng, 5), _prompt(rng, 7), _prompt(rng, 3)]
    return [np.concatenate([prefix, t]) for t in tails]


def _shared(side):
    eng = side.engine(slots=3)
    reqs = [side.Request(i, p, max_new=6, seed=20 + i)
            for i, p in enumerate(_shared_prompts())]
    # two ticks a request, so both prefix chunks index their pages before
    # the next sharer admits
    for r in reqs:
        eng.submit(r)
        eng.step()
        eng.step()
    eng.run_until_done()
    return _summary(eng, reqs)


def test_shared_prefix_streams_equal_an_unshared_engine(qwen):
    out = _both(qwen, _shared)
    assert out["prefix"]["hits"] == 4                # 2 pages x 2 sharers
    assert out["prefix"]["hit_rate"] > 0
    assert out["free"] == POOL                       # references drained
    _, _, tcfg, tp = qwen
    side = Side(True, tcfg, tp)
    base = []
    for i, p in enumerate(_shared_prompts()):
        eng = side.engine()
        r = Request(i, p, max_new=6, seed=20 + i)
        eng.submit(r)
        eng.run_until_done()
        base.append(r.out)
    assert out["streams"] == base                    # bitwise
    unshared = sum(-(-(len(p) + 6) // 8) for p in _shared_prompts())
    assert out["stats"]["peak_pages_used"] <= unshared - 4


def test_divergence_never_mutates_a_shared_page(qwen):
    """A sharer writes into its own fresh pages: the shared prefix pages
    hold the same bytes before and after a divergent request admits,
    decodes and finishes on top of them."""
    _, _, tcfg, tp = qwen
    rng = np.random.default_rng(8)
    prefix = _prompt(rng, 16)
    eng = Side(True, tcfg, tp).engine(slots=2)
    r0 = Request(0, np.concatenate([prefix, _prompt(rng, 4)]), max_new=24,
                 seed=1)
    eng.submit(r0)
    for _ in range(3):
        eng.step()
    shared = eng._slot_pages[0][:2]
    assert all(eng._alloc.is_indexed(pid) for pid in shared)
    pool = eng.cache["blocks"]["k"]
    before = pool[:, shared].clone()
    r1 = Request(1, np.concatenate([prefix, _prompt(rng, 6)]), max_new=6,
                 seed=2)
    eng.submit(r1)
    eng.run_until_done()
    assert r0.done and r1.done
    assert eng._alloc.prefix_hits == 2               # r1 reused both
    assert torch.equal(pool[:, shared], before)


# --- preemption --------------------------------------------------------------


def _evict(side, *, pool, max_len, new_a, new_b, steps):
    rng = np.random.default_rng(11 if pool == 7 else 12)
    pa, pb = _prompt(rng, 16), _prompt(rng, 16)
    eng = side.engine(pool=pool, max_len=max_len)
    ra = side.Request(1, pa, max_new=new_a, seed=11)
    eng.submit(ra)
    for _ in range(steps):
        eng.step()
    assert 0 < len(ra.out) < new_a
    rb = side.Request(2, pb, max_new=new_b, seed=22, priority=5)
    eng.submit(rb)
    eng.step()
    assert eng.stats["evictions"] == 1
    assert any(r is not None and r.rid == 2 for r in eng.active)
    held = len(eng._evicted.get(1, []))
    queued = any(q.rid == 1 for q, _ in eng.pending)
    eng.run_until_done()
    assert ra.done and rb.done
    assert eng.free_pages() == pool
    return dict(_summary(eng, [ra, rb]), held=held, queued=queued)


def _solo(qwen, prompt, max_new, seed, **kw):
    """The stream of one request alone on a fresh port engine."""
    _, _, tcfg, tp = qwen
    eng = Side(True, tcfg, tp).engine(pool=16, **kw)
    r = Request(1, prompt, max_new=max_new, seed=seed)
    eng.submit(r)
    eng.run_until_done()
    return r.out


def test_priority_eviction_resumes_bitwise(qwen):
    """A higher-priority arrival with no free pages preempts the resident;
    the victim re-queues with its written prefix pages held and resumes
    as a continuation whose stream equals an uninterrupted run."""
    out = _both(qwen, lambda side: _evict(side, pool=7, max_len=64,
                                          new_a=40, new_b=8, steps=4))
    assert out["queued"] and out["held"] > 0
    pa = _prompt(np.random.default_rng(11), 16)
    assert out["streams"][0] == _solo(qwen, pa, 40, 11)   # bitwise resume


def test_held_prefix_reclaimed_when_eviction_is_not_enough(qwen):
    """Evicting the victim still leaves too few pages (its prefix stays
    held), so preemption reclaims the held run; the victim re-prefills
    and still finishes bitwise."""
    out = _both(qwen, lambda side: _evict(side, pool=5, max_len=32,
                                          new_a=16, new_b=8, steps=3))
    assert out["queued"] and out["held"] == 0
    pa = _prompt(np.random.default_rng(12), 16)
    assert out["streams"][0] == _solo(qwen, pa, 16, 11, max_len=32)


def _equal_priority(side):
    rng = np.random.default_rng(13)
    eng = side.engine(pool=7)
    ra = side.Request(1, _prompt(rng, 16), max_new=40, seed=1)
    eng.submit(ra)
    for _ in range(4):
        eng.step()
    rb = side.Request(2, _prompt(rng, 16), max_new=8, seed=2)
    eng.submit(rb)
    eng.step()
    assert eng.stats["evictions"] == 0
    assert any(q.rid == 2 for q, _ in eng.pending)
    eng.run_until_done()
    return _summary(eng, [ra, rb])


def test_equal_priority_never_preempts(qwen):
    out = _both(qwen, _equal_priority)
    assert all(out["done"]) and out["stats"]["evictions"] == 0


def test_preemption_on_a_whole_prompt_engine(qwen):
    """Preemption does not need chunked prefill: on a whole-prompt paged
    engine the victim re-prefills prompt + delivered and its stream is the
    uninterrupted one."""
    rng = np.random.default_rng(16)
    pa, pb = _prompt(rng, 16), _prompt(rng, 12)

    def run(side):
        eng = side.engine(pool=7, prefill_chunk=None)
        ra = side.Request(1, pa, max_new=40, seed=3)
        eng.submit(ra)
        eng.step()
        eng.step()
        eng.submit(side.Request(2, pb, max_new=8, seed=4, priority=5))
        eng.run_until_done()
        return _summary(eng, [ra])
    out = _both(qwen, run)
    assert out["stats"]["evictions"] == 1 and out["free"] == 7
    assert out["streams"][0] == _solo(qwen, pa, 40, 3, prefill_chunk=None)


def test_preemption_on_a_dense_engine(qwen):
    """On the dense engine a blocked arrival finds no free slot: the
    resident is evicted, re-prefills prompt + delivered into its ring
    later, and its stream is the uninterrupted one."""
    rng = np.random.default_rng(18)
    pa, pb = _prompt(rng, 11), _prompt(rng, 7)
    _, _, tcfg, tp = qwen

    def run(side, high=True):
        cls = ServeEngine if side.port else JServeEngine
        extra = dict(device="cpu") if side.port else {}
        eng = cls(side.cfg, params=side.params, slots=1, max_len=64, seed=0,
                  chunk=4, **extra)
        ra = side.Request(1, pa, max_new=20, seed=3)
        eng.submit(ra)
        eng.step()
        eng.step()
        if high:
            eng.submit(side.Request(2, pb, max_new=6, seed=4, priority=5))
        eng.run_until_done()
        return _summary(eng, [ra])
    out = _both(qwen, run)
    assert out["stats"]["evictions"] == 1 and out["done"] == [True]
    assert out["streams"] == run(Side(True, tcfg, tp), high=False)["streams"]


# --- cancel and early EOS ------------------------------------------------------


def _cancel(side):
    """cancel() of a pending request, a mid-prefill one, a decoding one and
    an evicted continuation holding prefix pages; the pool returns to its
    baseline each time."""
    rng = np.random.default_rng(15)
    eng = side.engine(pool=7, slots=1)
    ra = side.Request(1, _prompt(rng, 16), max_new=40, seed=1)
    rp = side.Request(3, _prompt(rng, 9), max_new=4, seed=3)
    eng.submit(ra)
    eng.submit(rp)
    eng.step()                                       # ra mid-prefill
    assert eng._prefilling and eng.cancel(3)         # pending
    assert not any(q.rid == 3 for q, _ in eng.pending)
    assert eng.cancel(1) and not eng._prefilling     # mid-prefill
    assert eng.free_pages() == 7
    ra = side.Request(1, _prompt(rng, 16), max_new=40, seed=1)
    eng.submit(ra)
    for _ in range(4):
        eng.step()
    assert ra.out and not ra.done
    rb = side.Request(2, _prompt(rng, 16), max_new=16, seed=2, priority=5)
    eng.submit(rb)
    eng.step()
    assert eng.stats["evictions"] == 1
    held = len(eng._evicted.get(1, []))
    assert held > 0
    free = eng.free_pages()
    assert eng.cancel(1)                             # evicted, held pages
    assert not eng._evicted and eng.free_pages() == free + held
    for _ in range(3):
        eng.step()
    assert eng.cancel(2) and not rb.done             # decoding
    assert eng.free_pages() == 7 and not eng.has_work()
    assert not eng.cancel(2)                         # unknown now
    return _summary(eng, [ra, rb])


def test_cancel_in_every_state(qwen):
    out = _both(qwen, _cancel)
    assert out["free"] == 7 and not any(out["done"])


def test_early_eos_releases_the_whole_reservation(qwen):
    """A chunked request stopped by its EOS, at graduation (the first token)
    or mid-decode, returns every page of its prompt + budget reservation."""
    def run(side):
        rng = np.random.default_rng(17)
        p = _prompt(rng, 21)
        eng = side.engine()
        full = side.Request(0, p, max_new=12, seed=1)
        eng.submit(full)
        eng.run_until_done()
        outs = [full.out]
        for i, eos in enumerate((full.out[0], full.out[4])):
            r = side.Request(1 + i, p, max_new=12, seed=1, eos=eos)
            eng.submit(r)
            eng.run_until_done()
            assert r.done and r.out == full.out[:full.out.index(eos) + 1]
            assert eng.free_pages() == POOL
            outs.append(r.out)
        return dict(outs=outs, free=eng.free_pages())
    out = _both(qwen, run)
    assert out["outs"][1] == out["outs"][0][:1]      # done at graduation


def test_constructor_refuses_what_the_reference_refuses(qwen):
    _, _, tcfg, tp = qwen
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, params=tp, slots=1, max_len=32, prefill_chunk=8,
                    device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        Side(True, tcfg, tp).engine(prefill_chunk=12)
    with pytest.raises(ValueError, match="multiple"):
        Side(True, tcfg, tp).engine(prefill_chunk=0)
    with pytest.raises(ValueError, match="use_mtp"):
        ServeEngine(tsmoke(tget("deepseek-v3-671b")), slots=1, max_len=32,
                    paged=True, page_size=8, prefill_chunk=8, use_mtp=True,
                    device="cpu")


def test_a_prefilling_slot_is_masked_out_of_the_decode_chunk(qwen):
    """While a slot prefills, the decode chunk's static input keeps its
    buffer, the slot's lane goes in inactive, its table row stays at the
    trash page, and its host mirrors survive whatever state the chunk
    hands back for it."""
    _, _, tcfg, tp = qwen
    rng = np.random.default_rng(5)
    eng = Side(True, tcfg, tp).engine()
    chunk = eng._decode
    ptr = chunk.input.data_ptr()
    seen = []

    def scrambling(state):
        toks, emitted, st = chunk(state)
        seen.append(state["active"].copy())
        for name, junk in (("tokens", 7), ("positions", 33), ("left", 5),
                           ("tix", 9)):
            st[name] = np.where(state["active"], st[name], junk)
        return toks, emitted, st

    eng._decode = scrambling
    resident = Request(0, _prompt(rng, 9), max_new=30, seed=1)
    eng.submit(resident)
    eng.step()
    eng.step()
    long = Request(1, _prompt(rng, 40), max_new=8, seed=2)
    eng.submit(long)
    eng.step()
    slot = next(s for s in eng._prefilling)
    mirrors = [eng.positions[slot], eng._tokens[slot], eng._left[slot],
               eng._tix[slot]]
    eng.step()
    assert slot in eng._prefilling and not seen[-1][slot] and seen[-1].any()
    assert [eng.positions[slot], eng._tokens[slot], eng._left[slot],
            eng._tix[slot]] == mirrors
    assert (eng.cache["page_table"][slot] == eng.pool_pages).all()
    eng.run_until_done()
    assert chunk.input.data_ptr() == ptr
    assert resident.done and long.done and len(long.out) == 8
    assert (eng.cache["page_table"] == eng.pool_pages).all()


# --- DeepSeek-V3: the MLA chunk and mtp_h ------------------------------------


@pytest.fixture(scope="module")
def dsv3():
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
    return cfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_deepseek_v3_chunked_streams_and_logits_equal_jax(dsv3, storage):
    cfg, jp, tp = dsv3
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    kw = dict(slots=2, max_len=64, seed=0, chunk=4, paged=True, page_size=8,
              page_storage=storage, prefill_chunk=8)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (21, 13, 34)]
    with kernels.use_backend("ref"):
        jeng = JServeEngine(cfg, params=jp, **kw)
        ref = [JRequest(i, p, max_new=6) for i, p in enumerate(prompts)]
        for r in ref:
            jeng.submit(r)
        jeng.run_until_done()
    eng = ServeEngine(tcfg, params=tp, device="cpu", **kw)
    ours = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    for r in ours:
        eng.submit(r)
    eng.run_until_done()
    assert [r.out for r in ours] == [r.out for r in ref]
    assert eng.free_pages() == eng.pool_pages
    assert eng.stats["chunk_prefills"] == jeng.stats["chunk_prefills"] == 10

    # the first-token logits of the last chunk, and the MTP hidden it
    # leaves in the slot, straight from the model API
    # (the reference engine's own jitted chunk, already compiled for a
    # cache of its shapes)
    model = Model(tcfg, device="cpu")
    tparams = bridge.prepare_for_serving(tp, tcfg)
    jchunk = jeng._chunk_fn
    jcache = jeng.model.init_paged_cache(2, 64, 8, 16, storage)
    cache = model.init_paged_cache(2, 64, 8, 16, storage)
    p = prompts[2]
    L = len(p)
    row = np.full((1, 8), 16, np.int32)
    row[0, :5] = [3, 9, 0, 12, 7]
    with kernels.use_backend("ref"):
        for start in range(0, L, 8):
            toks = np.zeros((1, 8), np.int32)
            toks[0, :min(L, start + 8) - start] = p[start:start + 8]
            pos = np.arange(start, start + 8, dtype=np.int32)[None]
            lg, jcache = jchunk(jp, jcache, jnp.asarray(toks),
                                jnp.asarray(pos), jnp.asarray([L], jnp.int32),
                                jnp.asarray(row), 1)
            mine, _ = model.prefill_chunk(tparams, cache, toks, pos, [L],
                                          row, 1)
    ref = np.asarray(lg)
    err = np.abs(mine.numpy() - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), err
    h = np.asarray(jcache["mtp_h"])
    assert np.abs(cache["mtp_h"].numpy() - h).max() <= 1e-4 * np.abs(h).max()
    assert not cache["mtp_h"][0].any()               # other slot untouched
