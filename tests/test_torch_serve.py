"""PyTorch port: the paged serving path end to end against the JAX
``ServeEngine`` (smoke DeepSeek-V3 and smoke qwen3-14b, weights copied
from the JAX init).

Greedy token streams must be equal and the first-token logits within 1e-4
of the reference's largest logit, for ``page_storage`` bf16 and fp8, on
the default path and on the kernel path (``fp8_impl``/``attn_impl``
"pallas": the port's registry ops, whose plain versions run on the CPU;
the JAX side runs its registry's ``ref`` backend). Also: the port imports
nothing of JAX or of the reference package.
"""
import ast
import dataclasses
import pathlib

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
from repro_torch.kernels import registry
from repro_torch.models.api import Model, counter_uniform
from repro_torch.parallel.context import Mesh, ParallelCtx
from repro_torch.serve.engine import AdmissionError, Request, ServeEngine
from _torch_threads import one_thread  # noqa: F401


ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(slots=2, max_len=32, seed=0, chunk=4, paged=True, page_size=8)


def _prompts(vocab, n=3):
    return [np.arange(4 + i * 3) * (i + 3) % vocab for i in range(n)]


@pytest.fixture(scope="module")
def weights():
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _cfgs(kernel_path: bool):
    impl = "pallas" if kernel_path else "ref"
    cfg = dataclasses.replace(smoke_config(get_config("deepseek-v3-671b")),
                              fp8_impl=impl)
    tcfg = dataclasses.replace(tsmoke(tget("deepseek-v3-671b")),
                               fp8_impl=impl)
    return cfg, tcfg, ("pallas" if kernel_path else "")


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs]


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_streams_equal_jax_engine(weights, storage, kernel_path):
    jp, npp = weights
    cfg, tcfg, attn = _cfgs(kernel_path)
    prompts = _prompts(cfg.vocab_size)
    with kernels.use_backend("ref"):
        ref = _run(JServeEngine(cfg, params=jp, page_storage=storage,
                                attn_impl=attn, **KW),
                   [JRequest(i, p, max_new=6) for i, p in enumerate(prompts)])
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                      page_storage=storage, attn_impl=attn, device="cpu",
                      **KW)
    ours = _run(eng, [Request(i, p, max_new=6) for i, p in enumerate(prompts)])
    assert ours == ref
    assert all(len(o) == 6 for o in ours)
    assert eng.free_pages() == eng.pool_pages          # every page back
    # the kernel path serves its routed experts from E4M3 codes and scales
    stored = bridge.expert_storage(eng.params)
    assert stored["e4m3" if kernel_path else "plain"] > 0
    assert stored["plain" if kernel_path else "e4m3"] == 0


@pytest.mark.parametrize("kernel_path", [False, True])
def test_first_token_logits_match(weights, kernel_path):
    jp, npp = weights
    cfg, tcfg, _ = _cfgs(kernel_path)
    tparams = bridge.prepare_for_serving(bridge.params_from_jax(npp), tcfg)
    model = Model(tcfg, device="cpu")
    jprefill = jax.jit(lambda p, t, n: JModel(cfg).prefill(
        p, {"tokens": t}, lengths=n))
    for p in _prompts(cfg.vocab_size):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(p)] = p
        lengths = np.asarray([len(p)], np.int32)
        with kernels.use_backend("ref", clear_caches=False):
            ref, _ = jprefill(jp, jnp.asarray(toks), jnp.asarray(lengths))
        ours, cache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                    lengths=lengths)
        ref = np.asarray(ref)
        err = np.abs(ours.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), err
        assert cache["dense0"]["ckv"].shape == (1, 1, 16, 32)
        assert (cache["dense0"]["pos"][0, 0, len(p):] == -1).all()


def test_kernel_path_dispatches_through_registry_ops(weights, monkeypatch):
    """attn_impl/fp8_impl "pallas" reach every op of the slice (their
    plain versions here, on CPU tensors)."""
    _, npp = weights
    _, tcfg, attn = _cfgs(True)
    calls = {}
    for name in registry.names():
        op = registry.get(name)
        plain = op._plain

        def counted(*a, _plain=plain, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **k)
        monkeypatch.setattr(op, "_plain", counted)
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                      page_storage="fp8", attn_impl=attn, device="cpu", **KW)
    _run(eng, [Request(0, np.arange(5), max_new=4)])
    assert set(calls) == {"fp8_gemm", "moe_gemm", "paged_mla_decode"}


# --- qwen3-14b: GQA attention, dense FFN -----------------------------------------


@pytest.fixture(scope="module")
def qwen_weights():
    cfg = smoke_config(get_config("qwen3-14b"))
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_qwen_streams_equal_jax_engine(qwen_weights, storage, kernel_path):
    cfg, jp, npp = qwen_weights
    attn = "pallas" if kernel_path else ""
    prompts = _prompts(cfg.vocab_size)
    with kernels.use_backend("ref"):
        ref = _run(JServeEngine(cfg, params=jp, page_storage=storage,
                                attn_impl=attn, **KW),
                   [JRequest(i, p, max_new=6) for i, p in enumerate(prompts)])
    eng = ServeEngine(tsmoke(tget("qwen3-14b")),
                      params=bridge.params_from_jax(npp),
                      page_storage=storage, attn_impl=attn, device="cpu",
                      **KW)
    ours = _run(eng, [Request(i, p, max_new=6) for i, p in enumerate(prompts)])
    assert ours == ref
    assert all(len(o) == 6 for o in ours)
    assert eng.free_pages() == eng.pool_pages


@pytest.mark.parametrize("kernel_path", [False, True])
def test_qwen_first_token_logits_match(qwen_weights, kernel_path):
    cfg, jp, npp = qwen_weights
    impl = {"gqa_impl": "pallas"} if kernel_path else {}
    jmodel = JModel(cfg)
    jmodel.impl_ctx = dict(impl)
    model = Model(tsmoke(tget("qwen3-14b")), device="cpu")
    model.impl_ctx = dict(impl)
    tparams = bridge.prepare_for_serving(bridge.params_from_jax(npp),
                                         model.cfg)
    jprefill = jax.jit(lambda p, t, n: jmodel.prefill(p, {"tokens": t},
                                                      lengths=n))
    for p in _prompts(cfg.vocab_size):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(p)] = p
        lengths = np.asarray([len(p)], np.int32)
        with kernels.use_backend("ref", clear_caches=False):
            ref, _ = jprefill(jp, jnp.asarray(toks), jnp.asarray(lengths))
        ours, cache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                    lengths=lengths)
        ref = np.asarray(ref)
        err = np.abs(ours.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), err
        assert cache["blocks"]["k"].shape == (4, 1, 16, 4, 32)
        assert (cache["blocks"]["pos"][0, 0, len(p):] == -1).all()


def test_qwen_kernel_path_dispatches_through_both_attention_ops(
        qwen_weights, monkeypatch):
    """attn_impl "pallas" sends GQA prefill through flash_prefill and
    paged decode through paged_gqa_decode (their plain versions here, on
    CPU tensors), and nothing through the MLA/MoE/FP8 ops."""
    _, _, npp = qwen_weights
    calls = {}
    for name in registry.names():
        op = registry.get(name)
        plain = op._plain

        def counted(*a, _plain=plain, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **k)
        monkeypatch.setattr(op, "_plain", counted)
    eng = ServeEngine(tsmoke(tget("qwen3-14b")),
                      params=bridge.params_from_jax(npp), page_storage="fp8",
                      attn_impl="pallas", device="cpu", **KW)
    _run(eng, [Request(0, np.arange(5), max_new=4)])
    assert set(calls) == {"flash_prefill", "paged_gqa_decode"}
    # one prefill; one fused chunk of KW["chunk"] decode steps
    assert calls["flash_prefill"] == eng.cfg.num_layers
    assert calls["paged_gqa_decode"] == KW["chunk"] * eng.cfg.num_layers


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_qwen_cache_bytes_per_token_match_reference(qwen_weights, storage):
    cfg, jp, npp = qwen_weights
    ref = JServeEngine(cfg, params=jp, page_storage=storage, **KW)
    ours = ServeEngine(tsmoke(tget("qwen3-14b")),
                       params=bridge.params_from_jax(npp),
                       page_storage=storage, device="cpu", **KW)
    assert ours.cache_bytes_per_token() == pytest.approx(
        ref.cache_bytes_per_token())


def test_qwen3_14b_config_matches_reference():
    assert dataclasses.asdict(tget("qwen3-14b")) == dataclasses.asdict(
        get_config("qwen3-14b"))
    assert dataclasses.asdict(tsmoke(tget("qwen3-14b"))) == \
        dataclasses.asdict(smoke_config(get_config("qwen3-14b")))


def test_sampled_stream_depends_on_request_not_slot(weights):
    _, npp = weights
    _, tcfg, _ = _cfgs(False)
    p = np.arange(7) % 50

    def stream(n_before, seed):
        eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                          temperature=0.8, top_k=20, device="cpu", **KW)
        reqs = [Request(10 + i, np.arange(3) + i, max_new=3, seed=99)
                for i in range(n_before)]
        reqs.append(Request(0, p, max_new=6, seed=seed))
        _run(eng, reqs)
        return reqs[-1].out

    assert stream(0, 5) == stream(1, 5)
    assert stream(0, 5) != stream(0, 6)
    u = counter_uniform(torch.tensor([5, 5]), torch.tensor([0, 1]), 1000)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert not torch.equal(u[0], u[1])


def test_admission_and_pool_accounting(weights):
    _, npp = weights
    _, tcfg, _ = _cfgs(False)
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                      page_storage="fp8", max_pending=3, device="cpu", **KW)
    reqs = [Request(i, np.arange(5 + i), max_new=9) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    with pytest.raises(AdmissionError):
        eng.submit(Request(9, np.arange(3), max_new=2))
    eng.step()
    assert eng.pool_stats()["pages_used"] == 4       # 2 slots x 2 pages
    with pytest.raises(AdmissionError, match="no free slots"):
        eng.add_request(Request(8, np.arange(3), max_new=2))
    eng.run_until_done()
    assert all(r.done and len(r.out) == 9 for r in reqs)
    assert eng.pool_stats()["pages_free"] == eng.pool_pages
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(7, np.arange(30), max_new=8))


def test_admission_order_priority_and_page_skip_ahead(weights):
    """Pending requests admit highest priority first, and a request that
    fits jumps a page-blocked head (the reference's admission policy)."""
    _, npp = weights
    _, tcfg, _ = _cfgs(False)
    params = bridge.params_from_jax(npp)
    eng = ServeEngine(tcfg, params=params, device="cpu",
                      **dict(KW, pool_pages=5))
    a = Request(0, np.arange(16), max_new=8)      # 3 pages
    big = Request(1, np.arange(20), max_new=12)   # 4 pages: blocked
    small = Request(2, np.arange(4), max_new=4)   # 1 page: jumps ahead
    for r in (a, big, small):
        eng.submit(r)
    eng.step()
    assert a.out and small.done and not big.out
    eng.run_until_done()
    assert all(r.done for r in (a, big, small))

    eng = ServeEngine(tcfg, params=params, device="cpu", **dict(KW, slots=1))
    low = Request(0, np.arange(4), max_new=4)
    high = Request(1, np.arange(5), max_new=4, priority=1)
    eng.submit(low)
    eng.submit(high)
    eng.step()
    assert high.done and not low.out


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_cache_bytes_per_token_match_reference(weights, storage):
    jp, npp = weights
    cfg, tcfg, _ = _cfgs(False)
    ref = JServeEngine(cfg, params=jp, page_storage=storage, **KW)
    ours = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                       page_storage=storage, device="cpu", **KW)
    assert ours.cache_bytes_per_token() == pytest.approx(
        ref.cache_bytes_per_token())


def test_chunked_admission_refuses_extras():
    """Per-request extras (encoder or vision payloads) on a chunked engine
    raise the reference's ``ValueError``: they need whole-prompt
    prefill."""
    eng = ServeEngine(tsmoke(tget("deepseek-v3-671b")), device="cpu",
                      **dict(KW, prefill_chunk=8))
    eng.submit(Request(0, np.arange(4), max_new=2),
               {"src_embeds": np.zeros((1, 4, 8), np.float32)})
    with pytest.raises(ValueError, match="does not support extras"):
        eng.step()


@pytest.mark.parametrize("option", [dict(host_tier_pages=8),
                                    dict(prefill_chunk=8)])
def test_meshed_engine_takes_the_scheduler_options(option):
    """A mesh ctx serves with chunked prefill and with the host tier
    (ROADMAP.md's A.8 item, done): in a fake world of 2 on ``meta`` the
    meshed engine builds on (1, 2) with the option in force, its prefill
    chunk eager (a staged collective cannot be captured) and its GQA pool
    cut over the model axis. Their values: ``test_torch_serve_mesh.py``."""
    from repro_torch.launch import dryrun
    cfg = tsmoke(tget("qwen3-14b"))
    with dryrun.fake_world(2):
        eng = ServeEngine(cfg, params=Model(cfg, device="meta")
                          .param_structs(), device="meta",
                          ctx=ParallelCtx(mesh=Mesh.create((1, 2))),
                          **dict(KW, **option))
    assert eng.meshed and eng.trace_counts == {"decode": 0, "chunk": 0}
    if "prefill_chunk" in option:
        assert eng.prefill_chunk == 8 and not eng._prefill.graphed
    else:
        assert eng.tier.capacity_pages == 8
        assert eng.pool_stats()["host_pages_total"] == 8
    assert (eng.cache["blocks"]["k"].shape[-2]
            == cfg.num_kv_heads // 2)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="GPU"):
        Model(tsmoke(tget("deepseek-v3-671b")))


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, bad
