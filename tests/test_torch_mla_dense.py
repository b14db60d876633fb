"""PyTorch port: the dense-ring half of MLA decode and the dense-cache
engine against the JAX reference (``repro.core.mla``,
``repro.kernels.mla_attention``, ``repro.models.api``,
``repro.serve.engine`` with ``paged=False``).

Inputs come from numpy seeds; weights are the JAX ``Model.init`` tree of
smoke DeepSeek-V3 copied through ``bridge.params_from_jax``. The JAX
kernel op runs on the CPU's default backend (the Pallas kernel in
interpret mode). Tolerance: 1e-5 of the largest reference magnitude
(fp32 sums in another order; bf16 caches are exact in fp32) unless a test
says otherwise. Greedy token streams must be equal.
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
from repro.core import mla as jmla
from repro.kernels.mla_attention import ops as jmla_ops
from repro.kernels.mla_attention.ref import mla_decode_ref
from repro.models.api import Model as JModel
from repro.models.api import Segment as JSegment
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import mla
from repro_torch.kernels import registry
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.api import Model
from repro_torch.serve.engine import AdmissionError, Request, ServeEngine
from _torch_threads import one_thread  # noqa: F401


RTOL = 1e-5
KW = dict(slots=2, max_len=32, seed=0, chunk=4)


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


@pytest.fixture(scope="module")
def dsv3():
    """Smoke DeepSeek-V3 in both packages, one weight tree."""
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))  # jitted: faster
    return cfg, tcfg, jp, jax.tree.map(np.asarray, jp)


# --- the mla_decode kernel op --------------------------------------------------

# (B, H, R, Rr, T) and cache dtype: the reference's PARITY_CASES sweep
# (tests/test_kernel_registry.py), ragged T = 40 included
PARITY = [((2, 8, 64, 16, 64), "float32"), ((2, 8, 64, 16, 64), "bfloat16"),
          ((1, 4, 128, 32, 96), "float32"), ((3, 16, 32, 8, 128), "bfloat16"),
          ((1, 4, 64, 16, 40), "float32")]


def _op_inputs(dims, dtype, layout):
    """Both packages' operands. ``layout``: "prefix" (the parity cases'
    first 3T/4 rows valid), "wrapped" (a ring past one wrap: rows below
    the wrap point hold positions T.., the rest 0..T-1), "empty" (slot 0
    has no valid row)."""
    B, H, R, Rr, T = dims
    g = _gen(("mla_decode", dims, dtype, layout))
    qa = g.standard_normal((B, H, R)).astype(np.float32)
    qr = g.standard_normal((B, H, Rr)).astype(np.float32)
    ckv = torch.from_numpy(g.standard_normal((B, T, R)).astype(np.float32))
    kr = torch.from_numpy(g.standard_normal((B, T, Rr)).astype(np.float32))
    ckv, kr = ckv.to(getattr(torch, dtype)), kr.to(getattr(torch, dtype))
    t = np.arange(T, dtype=np.int32)
    if layout == "wrapped":
        wrap = np.arange(B, dtype=np.int32) * 3 + T // 3
        pos = np.where(t[None] <= wrap[:, None], t[None] + T, t[None])
        qpos = wrap + T
    else:
        npos = (T * 3) // 4
        pos = np.broadcast_to(np.where(t < npos, t, -1), (B, T)).copy()
        qpos = np.full((B,), npos - 1, np.int32)
        if layout == "empty":
            pos[0] = -1
    pos, qpos = pos.astype(np.int32), qpos.astype(np.int32)
    ours = (torch.from_numpy(qa), torch.from_numpy(qr), ckv, kr,
            torch.from_numpy(pos), torch.from_numpy(qpos))
    jdt = jnp.dtype(dtype)
    ref = (jnp.asarray(qa), jnp.asarray(qr),
           jnp.asarray(ckv.float().numpy()).astype(jdt),
           jnp.asarray(kr.float().numpy()).astype(jdt),
           jnp.asarray(pos), jnp.asarray(qpos))
    return ours, ref


@pytest.mark.parametrize("layout", ["prefix", "wrapped"])
@pytest.mark.parametrize("dims,dtype", PARITY)
def test_plain_matches_jax_interpret_kernel_and_ref(dims, dtype, layout):
    ours, ref = _op_inputs(dims, dtype, layout)
    out = mla_ops.mla_decode(*ours, scale=0.11)
    _close(out, jmla_ops.mla_decode(*ref, scale=0.11))    # interpret
    _close(out, mla_decode_ref(*ref, scale=0.11))


@pytest.mark.parametrize("dims,dtype", [PARITY[0], PARITY[4]])
def test_row_without_valid_key_is_zero_like_the_kernel(dims, dtype):
    ours, ref = _op_inputs(dims, dtype, "empty")
    out = mla_ops.mla_decode(*ours, scale=0.11)
    jout = jmla_ops.mla_decode(*ref, scale=0.11)
    assert float(np.abs(_np(jout)[0]).max()) == 0.0
    assert float(out[0].abs().max()) == 0.0
    _close(out, jout)
    # the full-softmax ref mixes the empty slot uniformly instead
    assert float(np.abs(_np(mla_decode_ref(*ref, scale=0.11))[0]).max()) > 0


def test_cpu_tensor_runs_plain_and_counts_nothing():
    ours, _ = _op_inputs(PARITY[0][0], "float32", "prefix")
    registry.reset_launch_counts()
    out = mla_ops.mla_decode(*ours, scale=0.11)
    _close(out, mla_ops.mla_decode.run_plain(*ours, scale=0.11), rtol=0.0)
    assert registry.launch_counts()["mla_decode"] == 0


# --- the kernel's split plan (shapes only; the kernel itself runs on the card,
# tests/test_torch_cuda.py) --------------------------------------------------------

# (B, H, T): DeepSeek-V3's dense decode (four slots, 128 heads, rings of 1024),
# one slot, a ragged T, longer rings and more slots, the reference's parity
# shapes (T = 40 among them)
RING_PLANS = [(4, 128, 1024), (1, 128, 1024), (3, 128, 1000), (4, 128, 2048),
              (8, 128, 4096), (2, 8, 64), (1, 4, 96), (3, 16, 128),
              (1, 4, 40)]


@pytest.mark.parametrize("dims", RING_PLANS)
def test_ring_split_plan_tiles_the_ring(dims):
    """Whole 32-row tiles, at most 128 rows a split, every ring row in
    exactly one split and no split wholly past the ring, a workspace of
    B*H*S accumulators of R plus m and l, and a function of the shapes and
    the SM count alone."""
    B, H, T = dims
    for sms in (132, 114):
        rps, S = mla_ops.ring_split_plan(B, H, T, sms)
        assert rps % mla_ops.RING_TILE == 0 and 0 < rps <= 128
        assert rps * S >= T and (S - 1) * rps < T
        splits = [range(s * rps, min((s + 1) * rps, T)) for s in range(S)]
        assert [t for r in splits for t in r] == list(range(T))
        for R in (512, 64):
            assert paged_ops.workspace_floats(B, H, S, R) == B * H * S * (R + 2)


@pytest.mark.parametrize("dims", RING_PLANS)
def test_ring_split_plan_reaches_two_ctas_per_sm(dims):
    """The grid (splits x groups of 16 heads x slots) reaches two CTAs per
    SM wherever the ring has rows enough: it falls short only where half
    a split would be under the 64-row floor."""
    B, H, T = dims
    for sms in (132, 114):
        rps, S = mla_ops.ring_split_plan(B, H, T, sms)
        ctas = B * -(-H // 16) * S
        assert ctas >= 2 * sms or rps // 2 < 64


@pytest.mark.parametrize("B,H,T,plan", [(4, 128, 1024, (64, 16)),
                                        (4, 128, 1000, (64, 16)),
                                        (1, 128, 1024, (64, 16)),
                                        (4, 128, 2048, (128, 16)),
                                        (2, 4, 40, (64, 1))])
def test_ring_split_plan_at_the_served_shapes(B, H, T, plan):
    """DeepSeek-V3 on 132 SMs: four rings of 1024 get 64-row splits, 512
    CTAs (the first kernel ran 64); T = 1000 the same 16 splits, the last
    of 40 rows; the reference's T = 40 is one split of 64 rows."""
    assert mla_ops.ring_split_plan(B, H, T, 132) == plan


# --- the dense latent ring ------------------------------------------------------


def test_init_mla_cache_matches_reference(dsv3):
    cfg, tcfg, _, _ = dsv3
    ref = jmla.init_mla_cache(cfg, 2, 3, 16)
    ours = mla.init_mla_cache(tcfg, 2, 3, 16, "cpu")
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == getattr(torch, str(ref[k].dtype))
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_step_past_a_ring_wrap(dsv3, impl, cache_dtype):
    """Twelve steps over a ring of 8 rows from positions 0, 3 and 6: every
    slot wraps. Outputs and the written ring agree with JAX each step."""
    cfg, tcfg, _, npp = dsv3
    cfg = dataclasses.replace(cfg, cache_dtype=cache_dtype)
    tcfg = dataclasses.replace(tcfg, cache_dtype=cache_dtype)
    jp = jax.tree.map(lambda v: jnp.asarray(v[0]), npp["dense0"]["attn"])
    tp = {k: torch.from_numpy(v[0].copy())
          for k, v in npp["dense0"]["attn"].items()}
    B, T = 3, 8
    jcache = jax.tree.map(lambda v: v[0], jmla.init_mla_cache(cfg, 1, B, T))
    cache = {k: v[0] for k, v in mla.init_mla_cache(tcfg, 1, B, T,
                                                     "cpu").items()}
    g = _gen(("ring", impl, cache_dtype))
    pos = np.array([[0], [3], [6]], np.int32)
    for _ in range(12):
        x = g.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jmla.mla_decode_step(
            jp, jcache, jnp.asarray(x), cfg=cfg, positions=jnp.asarray(pos),
            impl=impl)
        out, cache = mla.mla_decode_step(
            tp, cache, torch.from_numpy(x), cfg=tcfg,
            positions=torch.from_numpy(pos), impl=impl)
        _close(out, jout)
        pos = pos + 1
    for k in ("ckv", "kr"):
        _close(cache[k], jcache[k], rtol=1e-6)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert int(cache["pos"].max()) == 17          # wrapped past T


def test_entries_to_ring_matches_reference_short_ring(dsv3):
    """The ring assembly of prefill entries, with a ring shorter than the
    prompt (rows keep each residue's newest token) and ragged lengths."""
    cfg, tcfg, _, _ = dsv3
    g = _gen("e2r")
    n, B, S, T = 2, 3, 12, 5
    ckv = g.standard_normal((n, B, S, 32)).astype(np.float32)
    kr = g.standard_normal((n, B, S, 8)).astype(np.float32)
    lengths = np.array([12, 7, 3], np.int32)
    jm = JModel(cfg)
    ref = jm._entries_to_cache(JSegment("blocks", "moe", n),
                               (jnp.asarray(ckv), jnp.asarray(kr)),
                               B, S, T, jnp.asarray(lengths))
    model = Model(tcfg, device="cpu")
    entries = [(torch.from_numpy(ckv[i]), torch.from_numpy(kr[i]))
               for i in range(n)]
    ours = model._entries_to_cache(entries, S, T,
                                   torch.from_numpy(lengths))
    for k in ("ckv", "kr", "pos"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_prefill_with_extra_slots_matches_reference(dsv3):
    cfg, tcfg, jp, npp = dsv3
    model = Model(tcfg, device="cpu")
    tparams = bridge.prepare_for_serving(bridge.params_from_jax(npp), tcfg)
    p = np.arange(11) * 5 % cfg.vocab_size
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = p
    jprefill = jax.jit(lambda p, t, n: JModel(cfg).prefill(
        p, {"tokens": t}, extra_slots=16, lengths=n))
    with kernels.use_backend("ref"):
        ref, rcache = jprefill(jp, jnp.asarray(toks), jnp.asarray([11]))
    ours, cache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                extra_slots=16, lengths=[11])
    _close(ours, ref, rtol=1e-4)
    assert set(cache) == set(rcache)
    for seg in ("dense0", "blocks"):
        assert cache[seg]["ckv"].shape == (cache[seg]["ckv"].shape[0], 1, 32,
                                           32)
        for k in ("ckv", "kr"):
            _close(cache[seg][k], rcache[seg][k])
        np.testing.assert_array_equal(cache[seg]["pos"].numpy(),
                                      np.asarray(rcache[seg]["pos"]))


def test_cache_batch_axes_match_reference(dsv3):
    cfg, tcfg, _, _ = dsv3
    ref = JModel(cfg).cache_batch_axes(2, 16)
    assert Model(tcfg, device="cpu").cache_batch_axes(2, 16) == ref


# --- the dense-cache engine -------------------------------------------------------


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs]


@pytest.mark.parametrize("kernel_path", [False, True])
def test_dense_streams_equal_jax_engine(dsv3, kernel_path):
    """``ServeEngine(paged=False)``: greedy streams equal the JAX dense
    engine's (its registry on the ``ref`` backend), on the default path
    and on the kernel path (``fp8_impl``/``attn_impl`` "pallas")."""
    cfg, tcfg, jp, npp = dsv3
    impl = "pallas" if kernel_path else "ref"
    cfg = dataclasses.replace(cfg, fp8_impl=impl)
    tcfg = dataclasses.replace(tcfg, fp8_impl=impl)
    attn = "pallas" if kernel_path else ""
    prompts = [np.arange(4 + i * 3) * (i + 3) % cfg.vocab_size
               for i in range(3)]
    with kernels.use_backend("ref"):
        ref = _run(JServeEngine(cfg, params=jp, attn_impl=attn, **KW),
                   [JRequest(i, p, max_new=6) for i, p in enumerate(prompts)])
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                      attn_impl=attn, device="cpu", **KW)
    ours = _run(eng, [Request(i, p, max_new=6) for i, p in enumerate(prompts)])
    assert ours == ref
    assert all(len(o) == 6 for o in ours)
    assert eng.stats["splices"] == 3 and eng.free_pages() == 0
    # the kernel path serves its routed experts from E4M3 codes and scales
    stored = bridge.expert_storage(eng.params)
    assert stored["e4m3" if kernel_path else "plain"] > 0
    assert stored["plain" if kernel_path else "e4m3"] == 0


def test_dense_kernel_path_dispatches_through_mla_decode(dsv3, monkeypatch):
    """The dense engine's kernel path reaches fp8_gemm, moe_gemm and
    mla_decode (plain versions here, on CPU tensors) and not the paged
    attention op."""
    _, tcfg, _, npp = dsv3
    tcfg = dataclasses.replace(tcfg, fp8_impl="pallas")
    calls = {}
    for name in registry.names():
        op = registry.get(name)
        plain = op._plain

        def counted(*a, _plain=plain, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **k)
        monkeypatch.setattr(op, "_plain", counted)
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                      attn_impl="pallas", device="cpu", **KW)
    _run(eng, [Request(0, np.arange(5), max_new=4)])
    assert set(calls) == {"fp8_gemm", "moe_gemm", "mla_decode"}
    # one fused chunk of KW["chunk"] steps, one op call per layer
    assert calls["mla_decode"] == KW["chunk"] * tcfg.num_layers


def test_dense_accounting_matches_reference(dsv3):
    """No pages: admission needs only a slot, ``free_pages()`` and
    ``pool_stats()`` are zero, and the cache bytes per token are the
    rings' (values + ``pos``), as in the reference."""
    cfg, tcfg, jp, npp = dsv3
    ref = JServeEngine(cfg, params=jp, **KW)
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp), device="cpu",
                      **KW)
    assert eng.cache_bytes_per_token() == pytest.approx(
        ref.cache_bytes_per_token())
    assert eng.pool_stats() == ref.pool_stats()
    # a request longer than the ring is admitted (it wraps), as in the
    # reference; the slot limit still holds
    long = Request(0, np.arange(20), max_new=20)
    assert eng.can_admit(long)
    eng.add_request(long)
    eng.add_request(Request(1, np.arange(3), max_new=2))
    with pytest.raises(AdmissionError, match="no free slots"):
        eng.add_request(Request(2, np.arange(3), max_new=2))
    eng.run_until_done()
    assert long.done and len(long.out) == 20
    assert eng.free_slots() == [0, 1]
