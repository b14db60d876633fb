"""PyTorch port: the host KV page tier (``core/paged.HostPageTier``, the
page CRCs, ``serve/tier.py``'s transfer clock and staging helpers, and the
tier branches of ``ServeEngine``) against the JAX package, as
``tests/test_kv_tier.py`` runs it.

The tier's units take the same calls on both packages and must give the
same answers, the CRCs the same checksums on the same bytes. Each engine
scenario runs once on the JAX engine (its registry's ``ref`` backend, once
per module) and once on the port's, on the same weights
(``bridge.params_from_jax``), and the two must agree exactly: greedy
streams, ``tier_stats()``, ``pool_stats()``, ``prefix_stats()`` and every
``stats`` key but ``dispatches``, which the port counts its own way. Smoke
qwen3-14b with bf16 pages; smoke DeepSeek-V3 with fp8 pages for the MLA
payload and the ``mtp_h``/``mtp`` aux leaves a suspension carries. Sampled
streams are held against the port's own untiered engine: the port draws
its samples from its own generator (``models/api.sample_logits``).
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.core import paged as jpaged
from repro.models.api import Model as JModel
from repro.serve import tier as jtier
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import paged
from repro_torch.serve import tier
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_thread  # noqa: F401


def _weights(arch):
    cfg = smoke_config(get_config(arch))
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jp, tsmoke(tget(arch)), tp


@pytest.fixture(scope="module")
def qwen():
    return _weights("qwen3-14b")


@pytest.fixture(scope="module")
def dsv3():
    return _weights("deepseek-v3-671b")


# ---------------------------------------------------------------------------
# HostPageTier, CRCs and payload helpers: the same calls on both packages
# ---------------------------------------------------------------------------


def _payload(rng, pages=3):
    return {"x": rng.random((2, pages, 4)).astype(np.float32),
            "s": rng.random((1, pages, 4, 2)).astype(np.float32)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _residency(mod, as_tree):
    """test_kv_tier's residency cycle and illegal transitions; returns
    every answer the tier gives."""
    rng = np.random.default_rng(0)
    t = mod.HostPageTier(8)
    pay = as_tree(_payload(rng))
    aux = as_tree({"pos": np.arange(4, dtype=np.int32)})
    crcs = mod.payload_page_crcs(pay, 3)
    out = [crcs]
    eid = t.reserve(3)
    out += [eid, t.state(eid), t.used_pages(), t.free_pages()]
    t.commit(eid, pay, aux, crcs, mod.payload_crc(aux))
    out.append(t.state(eid))
    ent = t.begin_fetch(eid)
    out += [t.state(eid), mod.payload_page_crcs(ent.payload, 3) == crcs]
    t.abort_fetch(eid)
    out.append(t.state(eid))
    t.begin_fetch(eid)
    t.free(eid)
    out += [t.entries(), t.used_pages()]
    e2 = t.reserve(3)
    for bad in (lambda: t.begin_fetch(e2),
                lambda: t.commit(e2, pay, None, crcs[:2], 0),
                lambda: t.state(99)):
        with pytest.raises((ValueError, KeyError)) as info:
            bad()
        out.append((info.type.__name__, str(info.value)))
    t.commit(e2, pay, None, crcs, 0)
    with pytest.raises(ValueError) as info:
        t.commit(e2, pay, None, crcs, 0)
    out.append(str(info.value))
    return out


def _prefix_lru(mod, as_tree):
    """test_kv_tier's prefix LRU, reserve squeeze, run, take and drop."""
    rng = np.random.default_rng(2)
    t = mod.HostPageTier(4)
    out = []
    for i in range(4):
        pg = as_tree(_payload(rng, pages=1))
        out.append(t.put_prefix(bytes([i]), pg, mod.payload_crc(pg)))
    out.append(t.free_pages())
    out.append(t.reserve(3))
    out += [t.prefix_evictions, t.prefix_pages(), t.prefix_run([b"\x03"])]
    out += [t.reserve(2), t.reserve(99)]
    pg = as_tree(_payload(rng, pages=1))
    out += [t.put_prefix(b"new", pg, mod.payload_crc(pg)),
            t.prefix_run([b"\x03"])]
    t2 = mod.HostPageTier(8)
    keys = [bytes([i]) for i in range(3)]
    for k in keys:
        pg = as_tree(_payload(rng, pages=1))
        t2.put_prefix(k, pg, mod.payload_crc(pg))
    out += [t2.prefix_run(keys), t2.prefix_run(keys, granularity=2),
            t2.prefix_run([b"zz"] + keys)]
    out.append([crc for _, crc in t2.take_prefix(keys[:2])])
    t2.drop_prefix(keys[0])
    out += [t2.prefix_run(keys), t2.prefix_pages()]
    with pytest.raises(KeyError):
        t2.take_prefix([keys[0]])
    return out


@pytest.mark.parametrize("case", [_residency, _prefix_lru])
def test_host_page_tier_answers_as_the_reference(case):
    ours = case(paged, _torch_tree)
    assert ours == case(jpaged, lambda t: t)


def _fp8_payload(rng, pages):
    """A page payload as the JAX engine stages it (E4M3 codes as
    ``ml_dtypes.float8_e4m3fn``, bf16, fp32 scales, nested segments whose
    keys arrive out of sorted order) and as the port holds it (torch
    E4M3, bf16 and fp32 tensors of the same bits)."""
    codes = rng.integers(0, 256, (3, pages, 8, 16), dtype=np.uint8)
    bf = rng.standard_normal((3, pages, 8, 4)).astype(ml_dtypes.bfloat16)
    scale = rng.random((3, pages, 8)).astype(np.float32)
    ref = {"z": {"kr": bf, "ckv": codes.view(ml_dtypes.float8_e4m3fn),
                 "ckv_scale": scale},
           "blocks": {"k": codes.copy(), "k_scale": scale * 2}}
    ours = {"z": {"kr": torch.from_numpy(bf.view(np.uint16).copy()).view(
                      torch.bfloat16),
                  "ckv": torch.from_numpy(codes.copy()).view(
                      torch.float8_e4m3fn),
                  "ckv_scale": torch.from_numpy(scale.copy())},
            "blocks": {"k": torch.from_numpy(codes.copy()),
                       "k_scale": torch.from_numpy(scale * 2)}}
    return ref, ours


def test_page_crcs_equal_the_reference_on_the_same_bytes():
    """Per-page CRCs, the whole-tree CRC and the byte count of one payload
    equal the reference's: E4M3 folded through its bytes, leaves in
    sorted-key order at every level, numpy and tensor leaves alike."""
    rng = np.random.default_rng(3)
    ref, ours = _fp8_payload(rng, 5)
    assert paged.payload_page_crcs(ours, 5) == \
        jpaged.payload_page_crcs(ref, 5)
    assert paged.payload_page_crcs(ref, 5) == \
        jpaged.payload_page_crcs(ref, 5)
    assert paged.payload_crc(ours) == jpaged.payload_crc(ref)
    assert paged.payload_nbytes(ours) == jpaged.payload_nbytes(ref)
    # one flipped byte changes its page's CRC alone
    crcs = paged.payload_page_crcs(ours, 5)
    ours["blocks"]["k"][1, 3, 0, 0] ^= 0xFF
    flipped = paged.payload_page_crcs(ours, 5)
    assert [a != b for a, b in zip(crcs, flipped)] == \
        [False, False, False, True, False]


def test_page_helpers_equal_the_reference():
    rng = np.random.default_rng(5)
    ref = _payload(rng, pages=5)
    ours = _torch_tree(ref)
    for f, args in ((jtier.trim_pages, (3,)), (jtier.slice_page, (2,))):
        got = getattr(tier, f.__name__)(ours, *args)
        want = f(ref, *args)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
            assert got[k].is_contiguous()
    cut = tier.trim_pages(ours, 3)
    back, jback = tier.pad_pages(cut, 5), jtier.pad_pages(
        jtier.trim_pages(ref, 3), 5)
    whole = tier.concat_pages([tier.slice_page(ours, j) for j in range(5)])
    for k in ref:
        np.testing.assert_array_equal(back[k].numpy(), jback[k])
        np.testing.assert_array_equal(whole[k].numpy(), ref[k])


def test_staged_copies_never_alias_the_cache():
    """On the CPU ``staged_get`` copies each leaf (a payload must not
    change when the cache it came from is written in place), and
    ``staged_put`` hands a host tree back as it is."""
    src = {"a": torch.arange(6.0), "b": {"c": torch.ones(2, 3)}}
    got = tier.staged_get(src)
    src["a"].add_(1)
    src["b"]["c"].zero_()
    assert torch.equal(got["a"], torch.arange(6.0))
    assert torch.equal(got["b"]["c"], torch.ones(2, 3))
    assert tier.staged_put(got, "cpu") is got


# ---------------------------------------------------------------------------
# TransferClock: ETA, slow-link stretch, drop/retry/backoff, timeout
# ---------------------------------------------------------------------------


class _Hook:
    """Scriptable fault hook: drops while ``dropping`` is set."""

    def __init__(self, slow=1.0):
        self.dropping = False
        self._slow = slow

    def on_tick(self):
        pass

    def drop(self):
        return self.dropping

    def slow(self):
        return self._slow

    def full(self):
        return False


def _clock_trace(mod, cfg_kw, submits, drops, ticks):
    """Drive one clock: ``submits`` (kind, rid, slow) at tick 0, the link
    dropping on the ticks in ``drops``; returns what each tick landed and
    failed, and the clock's counters."""
    clk = mod.TransferClock(mod.TierConfig(**cfg_kw))
    ts = [clk.submit(getattr(mod, kind), rid, i, 100, slow=slow)
          for i, (kind, rid, slow) in enumerate(submits)]
    hook = _Hook()
    trace = []
    for tick in range(ticks):
        hook.dropping = tick in drops
        done, failed = clk.advance(hook)
        trace.append(([t.rid for t in done],
                      [(t.rid, t.failure) for t in failed]))
    dropped = clk.cancel(lambda t: t.rid == 1)
    return dict(trace=trace, retries=clk.retries, timeouts=clk.timeouts,
                per=[(t.retries, t.age, t.eta, t.backoff) for t in ts],
                cancelled=[t.rid for t in dropped],
                inflight=[t.rid for t in clk.inflight])


CLOCK_CASES = {
    "eta_and_slow": (dict(xfer_ticks=2), [("SPILL", 1, 1.0),
                                          ("FETCH", 2, 3.0)], (), 8),
    "drop_backoff_lands": (dict(xfer_ticks=1, max_retries=3),
                           [("FETCH", 7, 1.0)], (0,), 4),
    "retries_exhaust": (dict(xfer_ticks=1, max_retries=2, timeout_ticks=100),
                        [("FETCH", 7, 1.0)], tuple(range(20)), 20),
    "timeout": (dict(xfer_ticks=1, timeout_ticks=4),
                [("SPILL", 1, 100.0)], (), 10),
    "cancel": (dict(), [("SPILL", 1, 5.0), ("FETCH", 2, 5.0)], (), 1),
}


@pytest.mark.parametrize("case", sorted(CLOCK_CASES))
def test_transfer_clock_equals_the_reference(case):
    cfg_kw, submits, drops, ticks = CLOCK_CASES[case]
    ours = _clock_trace(tier, cfg_kw, submits, drops, ticks)
    assert ours == _clock_trace(jtier, cfg_kw, submits, drops, ticks)
    if case == "retries_exhaust":
        assert ours["per"][0][0] == 3      # initial + max_retries attempts
    if case == "timeout":
        assert ours["timeouts"] == 1


# ---------------------------------------------------------------------------
# Tiered engines against the JAX engine
# ---------------------------------------------------------------------------


class Side:
    """One engine family, the JAX reference or the port, on the weights
    both share."""

    def __init__(self, port, weights, storage="bf16"):
        cfg, jp, tcfg, tp = weights
        self.port = port
        self.cfg, self.params = (tcfg, tp) if port else (cfg, jp)
        self.storage = storage
        self.Request = Request if port else JRequest
        self.tier = tier if port else jtier

    def engine(self, *, pool=16, host=48, quantum=4, tier_kw=None,
               tiered=True, **kw):
        """test_kv_tier's bench sizing: a 2-slot device pool that holds
        two full requests, a host tier three times that."""
        cls = ServeEngine if self.port else JServeEngine
        if self.port:
            kw["device"] = "cpu"
        if tiered:
            kw.update(host_tier_pages=host, tier_config=self.tier.TierConfig(
                quantum=quantum, **(tier_kw or {})))
        return cls(self.cfg, params=self.params, slots=2, max_len=64,
                   seed=0, chunk=4, paged=True, page_size=8, pool_pages=pool,
                   page_storage=self.storage, prefill_chunk=8, **kw)

    def requests(self, n=10, max_new=24, seed0=0):
        rng = np.random.default_rng(7)
        return [self.Request(rid, rng.integers(1, 500, size=9 + rid)
                             .astype(np.int32), max_new=max_new,
                             seed=seed0 + rid) for rid in range(n)]

    def first_leaf(self, payload):
        """The payload's first leaf in tree order, as a writable byte
        array (to corrupt a host copy in place)."""
        if self.port:
            return paged.payload_leaves(payload)[0].view(torch.uint8) \
                .reshape(-1).numpy()
        return jax.tree.leaves(payload)[0].view(np.uint8).reshape(-1)


def _summary(eng, reqs):
    stats = {k: v for k, v in eng.stats.items() if k != "dispatches"}
    return dict(streams=[list(r.out) for r in reqs],
                done=[r.done for r in reqs], tier=eng.tier_stats(),
                pool=eng.pool_stats(), prefix=eng.prefix_stats(),
                stats=stats, free=eng.free_pages(),
                entries=0 if eng.tier is None else eng.tier.entries())


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return reqs


def _oversubscribed(side):
    eng = side.engine()
    return _summary(eng, _drain(eng, side.requests()))


def _sampled(side):
    eng = side.engine(temperature=0.8, top_k=8)
    return _summary(eng, _drain(eng, side.requests(8, seed0=40)))


def _fetch_failure(side):
    """Cut the link while entries sit in the tier: the fetch's retries
    run out and the request re-queues as a continuation."""
    hook = _Hook()
    eng = side.engine(tier_kw=dict(max_retries=1, timeout_ticks=8),
                      tier_faults=hook)
    reqs = side.requests()
    for r in reqs:
        eng.submit(r)
    for _ in range(200):
        eng.step()
        if any(e["state"] in ("host", "fetching")
               for e in eng._suspended.values()):
            break
    hook.dropping = True
    for _ in range(60):
        eng.step()
        if eng.tstats["degraded"] > 0:
            break
    hook.dropping = False
    eng.run_until_done()
    return _summary(eng, reqs)


def _crc_corruption(side):
    """Flip a byte of a host-tier copy: the fetch-time CRC catches it and
    the request recomputes through the re-queue."""
    eng = side.engine()
    reqs = side.requests()
    for r in reqs:
        eng.submit(r)
    corrupted = False
    for _ in range(300):
        eng.step()
        if not corrupted:
            for e in eng._suspended.values():
                if e["state"] == "host":
                    ent = eng.tier._entries[e["eid"]]
                    side.first_leaf(ent.payload)[0] ^= 0xFF
                    corrupted = True
                    break
        if not eng.has_work():
            break
    eng.run_until_done()
    assert corrupted
    return _summary(eng, reqs)


def _spill_failure(side):
    """A spill whose transfer dies resumes the slot in place."""
    hook = _Hook()
    eng = side.engine(tier_kw=dict(max_retries=1, timeout_ticks=8),
                      tier_faults=hook)
    reqs = side.requests()
    for r in reqs:
        eng.submit(r)
    for _ in range(200):
        eng.step()
        if eng._spilling_slots:
            hook.dropping = True
        if eng.tstats["spill_aborts"] > 0:
            hook.dropping = False
            break
    eng.run_until_done()
    return _summary(eng, reqs)


def _cancel_matrix(side):
    """Cancel one request in each residency state (spilling, host,
    fetching, ready); the rest completes with the pool recycled."""
    eng = side.engine(tier_kw=dict(xfer_ticks=2))
    reqs = side.requests(12, max_new=28)
    for r in reqs:
        eng.submit(r)
    hit, cancelled = [], []
    for _ in range(600):
        eng.step()
        if eng._spilling_slots and "spilling" not in hit:
            rid = next(iter(eng._spilling_slots.values()))
            assert eng.cancel(rid)
            hit.append("spilling")
            cancelled.append(rid)
        for want in ("host", "fetching", "ready"):
            if want in hit:
                continue
            rid = next((r_ for r_, e in eng._suspended.items()
                        if e["state"] == want), None)
            if rid is not None:
                assert eng.cancel(rid)
                hit.append(want)
                cancelled.append(rid)
        if not eng.has_work():
            break
    eng.run_until_done()
    assert not eng.cancel(999)
    return _summary(eng, reqs) | dict(
        hit=hit, cancelled=cancelled,
        inflight=len(eng._xfers.inflight))


def _tier_prefix(side):
    """Warm prefix pages harvested to the tier come back through the
    admission probe: a repeat of the prefix skips its chunks."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, 500, size=16).astype(np.int32)
    prompt_a = np.concatenate([prefix, rng.integers(1, 500, size=5)
                               .astype(np.int32)])
    prompt_b = np.concatenate([prefix, rng.integers(1, 500, size=7)
                               .astype(np.int32)])
    fillers = [rng.integers(1, 500, size=17 + i).astype(np.int32)
               for i in range(4)]
    flat = side.engine(pool=12, tiered=False)
    alone = _drain(flat, [side.Request(0, prompt_b, max_new=8, seed=3)])
    eng = side.engine(pool=12, host=24)
    r0 = _drain(eng, [side.Request(0, prompt_a, max_new=8, seed=9)])
    warm = eng._alloc.cached_free()
    fr = _drain(eng, [side.Request(10 + i, p, max_new=8, seed=20 + i)
                      for i, p in enumerate(fillers)])
    spilled = (eng.tstats["prefix_spilled"], eng.tier.prefix_pages())
    r1 = _drain(eng, [side.Request(99, prompt_b, max_new=8, seed=3)])
    return _summary(eng, r0 + fr + r1) | dict(
        warm=warm, spilled=spilled, alone=list(alone[0].out))


SCENARIOS = {"oversubscribed": _oversubscribed, "sampled": _sampled,
             "fetch_failure": _fetch_failure,
             "crc_corruption": _crc_corruption,
             "spill_failure": _spill_failure, "cancel_matrix": _cancel_matrix,
             "tier_prefix": _tier_prefix}
# (scenario, arch, page storage) cases; DeepSeek-V3 carries the MLA pages
# and the MTP aux leaves through a spill, a fetch and a CRC check
CASES = [(s, "qwen3-14b", "bf16") for s in SCENARIOS] + [
    ("oversubscribed", "deepseek-v3-671b", "fp8"),
    ("crc_corruption", "deepseek-v3-671b", "fp8")]


@pytest.fixture(scope="module")
def jax_runs(qwen, dsv3):
    """Every scenario on the JAX engine, once for the module."""
    weights = {"qwen3-14b": qwen, "deepseek-v3-671b": dsv3}
    with kernels.use_backend("ref"):
        return {(s, a, st): SCENARIOS[s](Side(False, weights[a], st))
                for s, a, st in CASES}


@pytest.fixture(scope="module")
def flat_streams(qwen, dsv3):
    """The port's untiered engine on the bench workload: the streams every
    tiered run must reproduce."""
    weights = {"qwen3-14b": qwen, "deepseek-v3-671b": dsv3}
    out = {}
    for arch, st, kw, reqs in (
            ("qwen3-14b", "bf16", {}, {}),
            ("deepseek-v3-671b", "fp8", {}, {}),
            ("qwen3-14b", "bf16", dict(temperature=0.8, top_k=8),
             dict(n=8, seed0=40))):
        side = Side(True, weights[arch], st)
        eng = side.engine(tiered=False, **kw)
        done = _drain(eng, side.requests(**reqs))
        assert all(r.done for r in done)
        out[arch, st, bool(kw)] = [list(r.out) for r in done]
    return out


@pytest.mark.parametrize("scenario,arch,storage", CASES)
def test_tiered_engine_equals_jax(qwen, dsv3, jax_runs, flat_streams,
                                  scenario, arch, storage):
    weights = {"qwen3-14b": qwen, "deepseek-v3-671b": dsv3}[arch]
    ours = SCENARIOS[scenario](Side(True, weights, storage))
    ref = dict(jax_runs[scenario, arch, storage])
    if scenario == "sampled":
        # the port samples from its own generator: its streams are held
        # against its own untiered engine below, everything else the JAX
        # engine's
        streams = ours.pop("streams")
        ref.pop("streams")
    assert ours == ref
    ts = ours["tier"]
    assert ours["free"] == (12 if scenario == "tier_prefix" else 16)
    assert ours["entries"] == 0 or scenario == "tier_prefix"
    assert ts["suspended"] == 0 and ts["transfers_inflight"] == 0
    if scenario == "cancel_matrix":
        assert sorted(ours["hit"]) == ["fetching", "host", "ready",
                                       "spilling"]
        assert all(d or i in ours["cancelled"]
                   for i, d in enumerate(ours["done"]))
        return
    assert all(ours["done"])
    if scenario == "tier_prefix":
        assert ours["warm"] >= 2 and min(ours["spilled"]) >= 2
        assert ts["prefix_fetched"] >= 2
        assert ours["prefix"]["tier_prefix_fetched"] >= 2
        assert ours["streams"][-1] == ours["alone"]
        return
    if scenario == "sampled":
        assert streams == flat_streams[arch, storage, True]
    else:
        assert ours["streams"] == flat_streams[arch, storage, False]
    if scenario == "oversubscribed":
        assert ts["suspensions"] > 0
        assert ts["resumes"] == ts["suspensions"]
        assert ts["spilled_pages"] == ts["fetched_pages"] > 0
        assert ts["prefetch_stalls"] == 0
        assert ts["degraded"] == 0 and ts["crc_failures"] == 0
        assert ts["peak_resident_pages"] > 16          # oversubscribed
    elif scenario == "fetch_failure":
        assert ts["degraded"] > 0
    elif scenario == "crc_corruption":
        assert ts["crc_failures"] >= 1 and ts["degraded"] >= 1
    elif scenario == "spill_failure":
        assert ts["spill_aborts"] > 0


def test_tier_hops_rebind_no_cache_leaf(qwen, dsv3):
    """Spills, fetches and resumes write into the cache's own tensors, the
    ones the decode and prefill-chunk graphs are captured over: after a
    tiered run every leaf (the MTP ``mtp_h`` and ring included) is the
    tensor it was."""
    side = Side(True, dsv3, "fp8")
    eng = side.engine()

    def ptrs(tree):
        if isinstance(tree, dict):
            return {k: ptrs(v) for k, v in tree.items()}
        return tree.data_ptr()

    before = ptrs(eng.cache)
    _drain(eng, side.requests(6))
    assert eng.tstats["suspensions"] > 0 and eng.tstats["resumes"] > 0
    assert ptrs(eng.cache) == before
    assert eng.trace_counts == {"decode": 0, "chunk": 0}


def test_stats_surfaces_and_refusals(qwen):
    side = Side(True, qwen)
    flat = side.engine(tiered=False)
    ts = flat.tier_stats()
    assert ts["host_pages_total"] == 0 and ts["suspended"] == 0
    assert "host_pages_total" not in flat.pool_stats()
    eng = side.engine()
    ps = eng.pool_stats()
    assert ps["host_pages_total"] == 48
    assert ps["host_pages_free"] == 48 and ps["host_occupancy"] == 0.0
    assert {"tier_prefix_pages", "tier_prefix_evictions",
            "tier_prefix_fetched"} <= set(eng.prefix_stats())
    cfg, _, tcfg, tp = qwen
    with pytest.raises(ValueError, match="paged=True"):
        ServeEngine(tcfg, params=tp, host_tier_pages=8, device="cpu")
    with pytest.raises(ValueError, match="tier_faults"):
        ServeEngine(tcfg, params=tp, paged=True, tier_faults=_Hook(),
                    device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        paged.HostPageTier(0)
