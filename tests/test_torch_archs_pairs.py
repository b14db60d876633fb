"""PyTorch port: llama4-maverick's dense/MoE pairs (``interleave:2``,
caches nested ``{"dense", "moe"}``) against the JAX package, at smoke
width (2 pairs, 8 experts top-1 plus the shared expert).

* The nested pools: ``prefill_to_pages`` -> ``install_pages`` ->
  ``gather_pages`` gives the reference's leaves and shapes, the values
  within 1e-5 of the largest (bf16 pages: the native fp32 cache at smoke
  width) or one E4M3 step where a rounding tie flips (fp8, dequantized);
  the port's gather returns exactly what it installed.
* A host-tiered engine (a 16-page pool oversubscribed by ten requests,
  48 host pages) spills and fetches the nested pools: streams, tier, pool
  and prefix stats equal to the JAX engine's.
* The dual-microbatch decode and ``Model.loss_dual`` as the reference's;
  the meshed engine and train step build for the pairs (their streams and
  trajectories: ``test_torch_mesh_families.py``).
* The disaggregator's handoff (dense rings, fp8 pages): streams and bytes
  as the JAX disaggregator's. Decode keeps every nested cache leaf's
  tensor. ``bridge.prepare_for_serving`` with ``fp8`` reaches both blocks
  of each pair, and the prepared tree's logits equal the raw tree's
  within 1e-5.

The engine streams: ``test_torch_archs_llama4.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_archs as h
from repro import kernels
from repro.models.api import Model as JModel
from repro.serve import tier as jtier
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.core import paged
from repro_torch.models.api import Model
from repro_torch.serve import tier
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "llama4-maverick-400b-a17b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return h.weights(ARCH)


def _np(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8) if t.dtype == torch.uint8 else
                t.float()).numpy()
    return np.asarray(t)


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_nested_pools_round_trip_equal_jax(weights, storage):
    jp, npp = weights
    cfg, tcfg = h.configs(ARCH)
    jm, tm = JModel(cfg), Model(tcfg, device="cpu")
    tp = bridge.prepare_for_serving(bridge.params_from_jax(npp), tcfg)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = np.arange(11) * 7 % cfg.vocab_size
    lengths = np.asarray([11], np.int32)
    ids = [3, 1]
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                       lengths=jnp.asarray(lengths))
    jpay = jm.prefill_to_pages(jc, 8, storage)["pages"]
    jcache = jm.init_paged_cache(1, 32, 8, 6, storage)
    jcache = jm.install_pages(jcache, jpay, jnp.asarray(ids))
    want = h.flat(jm.gather_pages(jcache, jnp.asarray(ids)))
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       lengths=lengths)
    pay = tm.prefill_to_pages(tc, 8, storage)["pages"]
    cache = tm.init_paged_cache(1, 32, 8, 6, storage)
    tm.install_pages(cache, pay, ids)
    got = h.flat(tm.gather_pages(cache, ids))
    assert sorted(got) == sorted(want)
    assert {p[:2] for p in got} == {("pat", "dense"), ("pat", "moe")}
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        # what was installed comes back, byte for byte (the pools hold
        # E4M3 codes as uint8)
        put = h.flat(pay)[path].contiguous()
        assert torch.equal(leaf.contiguous().view(torch.uint8),
                           put.view(torch.uint8)), path
        if path[-1].endswith("_scale"):
            continue
        a, b = _np(leaf), np.asarray(want[path])
        if storage == "fp8":
            a = _np(paged.dequantize_vecs(leaf, got[path[:-1] + (
                path[-1] + "_scale",)], 2))
            b = _np(paged.dequantize_vecs(
                torch.from_numpy(np.array(jax.lax.bitcast_convert_type(
                    b, jnp.uint8))),
                torch.from_numpy(np.array(want[path[:-1] + (
                    path[-1] + "_scale",)])), 2))
            tol = 2 ** -3                  # one E4M3 step where a tie flips
        else:
            tol = 1e-5
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), path


def _tiered(port, params, cfg):
    cls, req, mod = ((ServeEngine, Request, tier) if port else
                     (JServeEngine, JRequest, jtier))
    kw = dict(device="cpu") if port else {}
    eng = cls(cfg, params=params, slots=2, max_len=64, seed=0, chunk=4,
              paged=True, page_size=8, pool_pages=16, page_storage="fp8",
              prefill_chunk=8, host_tier_pages=48,
              tier_config=mod.TierConfig(quantum=4), **kw)
    rng = np.random.default_rng(7)
    reqs = [req(rid, rng.integers(1, 500, size=9 + rid).astype(np.int32),
                max_new=24) for rid in range(10)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    stats = {k: v for k, v in eng.stats.items() if k != "dispatches"}
    return dict(streams=[list(map(int, r.out)) for r in reqs],
                done=[r.done for r in reqs], tier=eng.tier_stats(),
                pool=eng.pool_stats(), prefix=eng.prefix_stats(),
                stats=stats, free=eng.free_pages())


def test_tiered_spill_and_fetch_equal_jax(weights):
    jp, npp = weights
    cfg, tcfg = h.configs(ARCH)
    with kernels.use_backend("ref"):
        ref = _tiered(False, jp, cfg)
    ours = _tiered(True, bridge.params_from_jax(npp), tcfg)
    assert ours == ref
    assert all(ours["done"]) and ours["free"] == 16
    ts = ours["tier"]
    assert ts["suspensions"] > 0 and ts["resumes"] == ts["suspensions"]
    assert ts["spilled_pages"] == ts["fetched_pages"] > 0


def test_decode_overlap_streams_equal_jax(weights):
    """The dual-microbatch decode (``decode_overlap=True``: the slots as
    two half-batches, each pair's blocks applied to both halves before the
    next pair) on the dense engine."""
    jp, npp = weights
    cfg, tcfg = h.configs(ARCH)
    kw = dict(h.KW, decode_overlap=True)
    prompts = h.prompts(cfg.vocab_size)
    with kernels.use_backend("ref"):
        ref = h.run(JServeEngine(cfg, params=jp, **kw),
                     [JRequest(i, p, max_new=h.MAX_NEW)
                      for i, p in enumerate(prompts)])
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp), device="cpu",
                      **kw)
    assert h.run(eng, [Request(i, p, max_new=h.MAX_NEW)
                        for i, p in enumerate(prompts)]) == ref


def test_loss_dual_matches_jax(weights):
    """``Model.loss_dual`` over two microbatches (the MoE stats from each
    pair's MoE block) against the reference's, within 1e-5."""
    from repro.data.pipeline import SyntheticCorpus
    jp, npp = weights
    cfg, tcfg = h.configs(ARCH)
    batch = SyntheticCorpus(cfg.vocab_size, 16, 4, seed=3).batch_at(0)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    jl, jmet = jax.jit(JModel(cfg).loss_dual)(
        jp, *[{k: jnp.asarray(v) for k, v in b.items()} for b in halves])
    loss, metrics = Model(tcfg, device="cpu").loss_dual(
        bridge.params_from_jax(npp),
        *[{k: torch.from_numpy(v) for k, v in b.items()} for b in halves])
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert sorted(metrics) == sorted(jmet)
    np.testing.assert_array_equal(metrics["pat/load_layers"].numpy(),
                                  np.asarray(jmet["pat/load_layers"]))


def test_pairs_under_a_mesh_wait_for_a11():
    """Meshed serving and meshed training of the dense/MoE pairs are
    ported (ROADMAP.md's A.11, done): in a fake world of 2 on ``meta`` the
    meshed engine builds on (1, 2) with each pair's experts cut over the
    model axis and its nested rings' KV heads cut, and the meshed train
    step builds. Their values: ``test_torch_mesh_families.py``."""
    from repro_torch.launch import dryrun
    from repro_torch.parallel.context import Mesh, ParallelCtx
    from repro_torch.train.trainer import TrainConfig, make_train_step
    _, tcfg = h.configs(ARCH)
    model = Model(tcfg, device="meta")
    with dryrun.fake_world(2):
        ctx = ParallelCtx(mesh=Mesh.create((1, 2)), moe_impl="ep_flat")
        eng = ServeEngine(tcfg, params=model.param_structs(), ctx=ctx,
                          device="meta")
        assert make_train_step(model, TrainConfig(), ctx=ctx)
    E = tcfg.moe.num_experts
    assert eng.params["pat"]["moe"]["moe"]["w1"].shape[1] == E // 2
    kv = tcfg.num_kv_heads // 2
    for k in ("dense", "moe"):
        assert eng.cache["pat"][k]["k"].shape[-2] == kv


@pytest.mark.parametrize("layout", ["dense", "fp8"])
def test_disaggregated_handoff_equals_jax(weights, layout):
    """A prefill pool handing each request's nested cache (dense: the
    batch-1 rings; paged: fp8 page payload) to a decode pool: the same
    streams and bytes per handoff as the JAX disaggregator."""
    from repro.serve import disagg as jdisagg
    from repro_torch.serve import disagg
    jp, npp = weights
    cfg, tcfg = h.configs(ARCH)
    kw = dict(decode_slots=2, max_len=32, chunk=4)
    if layout == "fp8":
        kw.update(paged=True, page_size=8, page_storage="fp8")
    out = []
    for port in (False, True):
        mod, R = (disagg, Request) if port else (jdisagg, JRequest)
        extra = dict(device="cpu") if port else {}
        with kernels.use_backend("ref"):
            dis = mod.Disaggregator(
                tcfg if port else cfg,
                params=bridge.params_from_jax(npp) if port else jp, **kw,
                **extra)
            reqs = [R(i, p, max_new=h.MAX_NEW)
                    for i, p in enumerate(h.prompts(cfg.vocab_size))]
            for r in reqs:
                dis.submit(r)
            nbytes = [x.nbytes for x in dis.queue]
            dis.run()
        out.append(([list(map(int, r.out)) for r in reqs], nbytes,
                    dis.handoff_bytes))
    assert out[1] == out[0]
    assert all(len(s) == h.MAX_NEW for s in out[1][0])


def _cache_leaves(cache):
    """Every tensor under the cache's nested dicts (pools, rings)."""
    return paged.payload_leaves({k: v for k, v in cache.items()
                                 if isinstance(v, dict)})


@pytest.mark.parametrize("paged", [False, True])
def test_decode_keeps_every_nested_cache_leaf(weights, paged):
    """``decode_loop`` writes the nested rings and pools in place: every
    leaf keeps its tensor (a captured decode chunk replays the same
    buffers)."""
    _, npp = weights
    eng = h.port_engine(ARCH, npp, "paged-fp8" if paged else "dense",
                        False)
    before = [t.data_ptr() for t in _cache_leaves(eng.cache)]
    h.port_streams(eng)
    assert [t.data_ptr() for t in _cache_leaves(eng.cache)] == before


def test_prepare_for_serving_walks_the_pairs(weights):
    """With ``fp8`` on the kernel path the load-time preparation reaches
    both blocks of each pair: the MoE block's routed experts become E4M3
    codes, its shared expert and the dense block's FFN their straight-
    through values and FP8 blocks (input width >= 256), the router stays;
    the prepared tree's logits equal the per-call quantization's."""
    from repro_torch.core import fp8
    _, npp = weights
    _, tcfg = h.configs(ARCH, kernel_path=True)
    tcfg = dataclasses.replace(tcfg, fp8=True)
    raw = bridge.params_from_jax(npp)
    ready = bridge.prepare_for_serving(raw, tcfg)
    pat = ready["pat"]
    assert isinstance(pat["moe"]["moe"]["w1"], fp8.Fp8Experts)
    assert isinstance(pat["dense"]["mlp"]["w_down"], fp8.Fp8Weight)
    assert isinstance(pat["moe"]["moe"]["w_gate"], torch.Tensor)
    stored = bridge.expert_storage(ready)
    pairs = tcfg.num_layers // 2
    assert stored["e4m3"] == 3 * pairs * tcfg.moe.num_experts
    assert stored["plain"] == 0 and ready["plain_expert_matrices"] == 0
    model = Model(tcfg, device="cpu")
    toks = {"tokens": torch.arange(12)[None] * 5 % tcfg.vocab_size}
    a, _ = model.prefill(ready, toks)
    b, _ = model.prefill(raw, toks)
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
