"""PyTorch port: the enc-dec family — seamless-m4t-large-v2 (a non-causal
encoder over the request's frame embeddings; decoder blocks of
self-attention, cross-attention over the encoder's memory and FFN) —
against the JAX package on the CPU, at smoke width in fp32 on
``bridge.params_from_jax`` weights (harness: ``_torch_crossattn.py``).

* ``gqa_attention`` as cross-attention (``kv_x``, no RoPE, not causal)
  and as the encoder's non-causal self-attention, and the decoder and
  encoder blocks: within 1e-5 of the reference's functions.
* At full size, nothing allocated: every parameter as the reference's,
  ``count_params`` 2 034 784 256 (and equal at smoke width).
* ``_encode``, bucketed prefill logits with every cache leaf it assembles
  (the ``memory`` leaf among them), and three decode steps: 1e-5.
* Greedy streams and engine counters equal the JAX engine's on the dense
  engine, paged bf16 and paged fp8 pages, on the default path and on the
  kernel path (``attn_impl="pallas"``: the decoder's self-attention
  through ``flash_prefill`` and ``paged_gqa_decode``; the encoder and the
  cross-attention stay on the plain path, as the reference's). The
  requests' 6 and 13 frames are shorter than the 16-row memory leaf: the
  admitted memory is zero-padded, and decode attends over every row of
  it, the reference's behaviour (held on the logits of an admitted cache).
* With the extras kept per slot: a priority-5 arrival evicts a resident
  that re-prefills with its frames; the host tier suspends and resumes
  residents with their memory rows; a ``cancel``; the unmeshed
  disaggregator's handoff carries the memory.
* ``Model.loss`` within 1e-5 and every gradient within 1e-4.
* Refusals as the reference's: chunked admission with extras and
  ``decode_overlap=True`` (``ValueError``); the meshed engine (its memory
  leaf whole on each model column), train step and disaggregator build.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_archs as h
import _torch_crossattn as x
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.api import Model as JModel
from repro.serve import tier as jtier
from repro.serve.disagg import Disaggregator as JDisaggregator
from repro_torch.models import layers, transformer
from repro_torch.models.api import Model
from repro_torch.models.param import layer
from repro_torch.serve import tier
from repro_torch.serve.disagg import Disaggregator
from repro_torch.serve.engine import ServeEngine

CASE = "seamless"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, B=2, S=7, T=5, seed=0):
    """Seeded hidden states (B, S, d) and a memory (B, T, d), numpy."""
    rng = np.random.default_rng(seed)
    return ((0.5 * rng.normal(size=(B, S, cfg.d_model))).astype(np.float32),
            (0.5 * rng.normal(size=(B, T, cfg.d_model))).astype(np.float32))


def _ctx(S, T, B=2, torch_=False):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    mp = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    if torch_:
        return torch.from_numpy(pos.copy()), torch.from_numpy(mp.copy())
    return jnp.asarray(pos), jnp.asarray(mp)


# ---------------------------------------------------------------------------
# Attention and blocks against the reference's functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cross", "noncausal"])
def test_gqa_attention_cross_and_noncausal(kind):
    jp, npp = x.weights(CASE)
    cfg, tcfg = x.configs(CASE)
    h_, mem = _inputs(cfg)
    S, T = h_.shape[1], mem.shape[1]
    sub = "xattn" if kind == "cross" else "attn"
    jpl = jax.tree.map(lambda a: a[0], jp["dec"][sub])
    tpl = layer(x.port_params(CASE)["dec"][sub], 0)
    pos, mp = _ctx(S, T)
    tpos, tmp = _ctx(S, T, torch_=True)
    if kind == "cross":
        ref, _ = jlayers.gqa_attention(
            jpl, jnp.asarray(h_), cfg=cfg, positions=pos, causal=False,
            kv_x=jnp.asarray(mem), kv_positions=mp)
        ours, _ = layers.gqa_attention(
            tpl, torch.from_numpy(h_), cfg=tcfg, positions=tpos,
            causal=False, kv_x=torch.from_numpy(mem), kv_positions=tmp)
    else:
        ref, _ = jlayers.gqa_attention(jpl, jnp.asarray(h_), cfg=cfg,
                                       positions=pos, causal=False)
        ours, _ = layers.gqa_attention(tpl, torch.from_numpy(h_), cfg=tcfg,
                                       positions=tpos, causal=False)
        causal, _ = layers.gqa_attention(tpl, torch.from_numpy(h_),
                                         cfg=tcfg, positions=tpos)
        assert x.rel(causal.numpy(), ref) > 1e-3      # the mask matters
    assert x.rel(ours.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("block", ["decoder", "encoder"])
def test_blocks_match_the_reference(block):
    jp, _ = x.weights(CASE)
    cfg, tcfg = x.configs(CASE)
    h_, mem = _inputs(cfg, seed=1)
    S, T = h_.shape[1], mem.shape[1]
    pos, mp = _ctx(S, T)
    tpos, tmp = _ctx(S, T, torch_=True)
    if block == "decoder":
        jpl = jax.tree.map(lambda a: a[0], jp["dec"])
        tpl = layer(x.port_params(CASE)["dec"], 0)
        ref = jtfm.decoder_block_apply(
            jpl, jnp.asarray(h_), cfg, dict(positions=pos, causal=True,
                                            memory=jnp.asarray(mem),
                                            mem_positions=mp))[0]
        ours = transformer.decoder_block_apply(
            tpl, torch.from_numpy(h_), tcfg,
            dict(positions=tpos, memory=torch.from_numpy(mem),
                 mem_positions=tmp))[0]
    else:
        jpl = jax.tree.map(lambda a: a[0], jp["enc"])
        tpl = layer(x.port_params(CASE)["enc"], 0)
        ref = jtfm.encoder_block_apply(jpl, jnp.asarray(h_), cfg,
                                       dict(positions=pos))[0]
        ours = transformer.encoder_block_apply(
            tpl, torch.from_numpy(h_), tcfg, dict(positions=tpos))[0]
    assert x.rel(ours.numpy(), ref) <= 1e-5


def test_encode_matches_the_reference():
    jp, _ = x.weights(CASE)
    cfg, tcfg = x.configs(CASE)
    src = x.extras(cfg, 1, batch=2)["src_embeds"]
    ref = JModel(cfg)._encode(jp, jnp.asarray(src))
    ours = Model(tcfg, device="cpu")._encode(x.port_params(CASE),
                                             torch.from_numpy(src))
    assert x.rel(ours.numpy(), ref) <= 1e-5


def test_param_shapes_and_counts_equal_the_reference():
    x.check_counts(CASE, 2_034_784_256)


def test_prefill_cache_and_decode_logits_match_jax():
    x.check_logits(CASE)


# ---------------------------------------------------------------------------
# Engines: streams, the memory leaf, eviction, the tier, cancel, handoff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["default", "kernel"])
@pytest.mark.parametrize("mode", ["dense", "paged-bf16", "paged-fp8"])
def test_streams_equal_jax(mode, kernel_path, monkeypatch):
    ref = x.streams(CASE, False, mode, kernel_path)
    calls = h.counted_ops(monkeypatch)
    ours = x.streams(CASE, True, mode, kernel_path)
    assert ours == ref
    assert all(len(s) == x.MAX_NEW for s in ours["streams"])
    if not kernel_path:
        assert calls == {}
        return
    # the decoder's self-attention only: the encoder and the
    # cross-attention pass no impl (the reference's choice), so a prefill
    # launches flash_prefill once a decoder layer, not once a layer of both
    # stacks
    n = x.configs(CASE)[1].num_layers
    assert calls.pop("flash_prefill") == len(x.LENGTHS) * n
    if mode != "dense":
        assert calls.pop("paged_gqa_decode") % n == 0
    assert calls == {}


@pytest.mark.parametrize("mode", ["dense", "paged-fp8"])
def test_admitted_memory_is_zero_padded_and_decoded_as_the_reference(mode):
    """A request of 6 frames admitted (``add_request``) into a 16-row
    memory leaf: rows 6-15 are zero on both packages, and a decode step
    over the two admitted caches gives the same logits (1e-5): every row of
    the leaf is attended over, as the reference does."""
    cfg, tcfg = x.configs(CASE)
    prompt = x.prompts(cfg.vocab_size)[1]
    ex = x.extras(cfg, 0)
    caches = []
    for port in (False, True):
        eng = x.engine(CASE, port, mode, slots=1)
        req = x.requests(port, cfg.vocab_size, max_new=8)[1]
        first = eng.add_request(req, ex)
        caches.append((eng, first))
    (jeng, jfirst), (teng, tfirst) = caches
    assert jfirst == tfirst
    jmem, tmem = np.asarray(jeng.cache["memory"]), teng.cache["memory"]
    assert jmem.shape == tuple(tmem.shape) == (1, 16, cfg.d_model)
    assert not np.abs(jmem[:, 6:]).any() and not tmem[:, 6:].abs().any()
    assert x.rel(tmem.numpy(), jmem) <= 1e-5
    tok = np.asarray([[tfirst]], np.int32)
    pos = np.asarray([[len(prompt)]], np.int32)
    ref, _ = jeng.model.decode_step(jeng.params, jeng.cache,
                                    jnp.asarray(tok), jnp.asarray(pos))
    ours, _ = teng.model.decode_step(teng.params, teng.cache,
                                     torch.from_numpy(tok),
                                     torch.from_numpy(pos))
    assert x.rel(ours.numpy(), np.asarray(ref)) <= 1e-5


def _evicting(port):
    """Two residents decoding, then a priority-5 arrival: the lowest
    resident is evicted and comes back, re-prefilled with its frames."""
    eng = x.engine(CASE, port, "paged-fp8")
    reqs = x.requests(port, eng.cfg.vocab_size, max_new=12,
                      priorities=(0, 0, 5))
    x.submit_all(eng, reqs[:2])
    eng.step()
    eng.step()
    x.submit_all(eng, reqs[2:])
    eng.run_until_done()
    return x.summary(eng, reqs)


def test_priority_eviction_readmits_with_its_extras():
    ref = _evicting(False)
    ours = _evicting(True)
    assert ours == ref
    assert ours["stats"]["evictions"] >= 1 and all(ours["done"])


def _tiered(port):
    """Three requests on two slots of a tiered paged engine, a quantum of
    two ticks: residents are suspended to the host tier (pages and the
    memory rows) and resume without recompute."""
    mod = tier if port else jtier
    eng = x.engine(CASE, port, "paged-bf16", host_tier_pages=48,
                   tier_config=mod.TierConfig(quantum=2))
    reqs = x.requests(port, eng.cfg.vocab_size, max_new=16)
    x.submit_all(eng, reqs)
    eng.run_until_done()
    out = x.summary(eng, reqs)
    out.update(tier=eng.tier_stats(), free=eng.free_pages())
    return out


def test_host_tier_suspends_and_resumes_with_the_memory():
    ref = _tiered(False)
    ours = _tiered(True)
    assert ours == ref
    assert ours["tier"]["suspensions"] >= 1
    assert ours["tier"]["resumes"] == ours["tier"]["suspensions"]
    assert ours["free"] == 16


def _cancelled(port):
    eng = x.engine(CASE, port, "paged-fp8")
    reqs = x.requests(port, eng.cfg.vocab_size, max_new=12)
    x.submit_all(eng, reqs)
    eng.step()
    assert eng.cancel(1) and eng.cancel(2)    # decoding, and queued
    eng.run_until_done()
    return dict(x.summary(eng, reqs), free=eng.free_pages())


def test_cancel_frees_a_resident_and_a_queued_request():
    ref = _cancelled(False)
    ours = _cancelled(True)
    assert ours == ref
    assert ours["done"] == [True, False, False] and ours["free"] == 16


def _handoff(port):
    cfg = x.configs(CASE)[int(port)]
    kw = dict(decode_slots=2, max_len=64, chunk=4, paged=True, page_size=8,
              page_storage="fp8")
    if port:
        dis = Disaggregator(cfg, params=x.port_params(CASE), device="cpu",
                            **kw)
    else:
        dis = JDisaggregator(cfg, params=x.weights(CASE)[0], **kw)
    reqs = x.requests(port, cfg.vocab_size)
    for r in reqs:
        dis.submit(r, x.extras(cfg, r.rid))
    dis.run()
    return dict(streams=[list(map(int, r.out)) for r in reqs],
                done=[r.done for r in reqs], bytes=dis.handoff_bytes)


def test_disaggregator_handoff_carries_the_memory():
    ref = _handoff(False)
    ours = _handoff(True)
    assert ours == ref and all(ours["done"])


def test_decode_keeps_every_cache_leaf():
    """``decode_loop`` writes the rings in place and reads the memory leaf
    where admission wrote it: a captured decode chunk replays one set of
    buffers."""
    eng = x.engine(CASE, True, "dense")
    before = {p: t.data_ptr() for p, t in h.flat(eng.cache).items()}
    assert ("memory",) in before
    reqs = x.requests(True, eng.cfg.vocab_size)
    x.submit_all(eng, reqs)
    eng.run_until_done()
    assert {p: t.data_ptr() for p, t in h.flat(eng.cache).items()} == before


# ---------------------------------------------------------------------------
# Training, and the refusals
# ---------------------------------------------------------------------------


def test_loss_and_every_gradient_leaf_match_jax():
    mags = x.check_loss_and_grads(CASE)
    assert mags[("enc", "attn", "wq")] > 0 and mags[("dec", "xattn", "wk")] > 0


def _refusal(port, **kw):
    eng = x.engine(CASE, port, **kw)
    req = x.requests(port, eng.cfg.vocab_size)[0]
    eng.submit(req, x.extras(eng.cfg, 0))
    with pytest.raises(ValueError) as info:
        eng.run_until_done()
    return str(info.value)


@pytest.mark.parametrize("option", ["chunked", "decode_overlap"])
def test_refusals_are_the_reference_value_errors(option):
    kw = (dict(mode="chunked") if option == "chunked"
          else dict(decode_overlap=True))
    assert _refusal(True, **kw) == _refusal(False, **kw)


def test_mesh_waits_for_a13():
    """Meshed serving, meshed training and a meshed disaggregator are
    ported for the families with a memory (ROADMAP.md's A.13, done): in a
    fake world of 2 on ``meta`` each builds on (1, 2), the engine's
    ``memory`` leaf whole on each model column (its slots, rows and
    width). Their values: ``test_torch_mesh_families.py``."""
    from repro_torch.launch import dryrun
    from repro_torch.parallel.context import Mesh, ParallelCtx
    from repro_torch.train.trainer import TrainConfig, make_train_step
    for case in x.CASES:
        _, tcfg = x.configs(case)
        model = Model(tcfg, device="meta")
        with dryrun.fake_world(2):
            ctx = ParallelCtx(mesh=Mesh.create((1, 2)))
            eng = ServeEngine(tcfg, params=model.param_structs(), ctx=ctx,
                              device="meta", max_len=64)
            assert make_train_step(model, TrainConfig(), ctx=ctx)
            dis = Disaggregator(tcfg, params=model.param_structs(),
                                ctx=ctx, device="meta", max_len=64)
        rows = (tcfg.num_patches if tcfg.family == "vlm"
                else int(64 * tcfg.src_len_ratio))
        for e in (eng, dis.decode):
            assert tuple(e.cache["memory"].shape) == (e.slots, rows,
                                                      tcfg.d_model)


@pytest.mark.parametrize("case", list(x.CASES))
def test_fp8_preparation_reaches_every_linear(case):
    """Neither config sets ``fp8``; with it (at d_model 256, so every
    projection takes the FP8 path) the load-time preparation gives each
    linear of the encoder, the decoder, the cross-attention and the
    vision pattern's ``(n, k)``-stacked self blocks its ``Fp8Weight``, and
    the prepared tree's prefill logits equal those of the same weights
    quantized per call (the reference's way) within 1e-6. Against the
    reference itself an FP8 model is held where no E4M3 code can flip: the
    encoder's output within 1e-5. Past it an ulp of summation order
    upstream of a quantization flips codes now and then (ROADMAP.md §C),
    so the prefill logits are held within 0.1 of the largest, which a
    wrong scale or a missing cross-attention exceeds many times."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.core import fp8
    cfg, tcfg = (dataclasses.replace(c, fp8=True, d_model=256)
                 for c in x.configs(case))
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(2))
    npp = jax.tree.map(np.asarray, jp)
    raw = bridge.params_from_jax(npp)
    ready = bridge.prepare_for_serving(bridge.params_from_jax(npp), tcfg)
    flat = h.flat({k: v for k, v in ready.items() if isinstance(v, dict)})
    quantized = {p for p, v in flat.items() if isinstance(v, fp8.Fp8Weight)}
    subtrees = ({"enc", "dec", "xattn"} if case == "seamless"
                else {"cross", "selfs", "xattn"})
    assert all(any(s in p for p in quantized) for s in subtrees), quantized
    for p, v in flat.items():
        if isinstance(v, fp8.Fp8Weight):
            assert v.wq.shape == v.w.shape and v.ws.shape[:-2] == \
                v.w.shape[:-2], p
    toks = np.arange(12, dtype=np.int32)[None] * 5 % cfg.vocab_size
    ex = x.extras(cfg, 1)
    model = Model(tcfg, device="cpu")
    batch = dict(ex, tokens=torch.from_numpy(toks))
    ours, _ = model.prefill(ready, batch)
    per_call, _ = model.prefill(dict(raw, prepared=True), batch)
    assert x.rel(ours.numpy(), per_call.numpy()) <= 1e-6
    ref, _ = JModel(cfg).prefill(jp, dict(
        {k: jnp.asarray(v) for k, v in ex.items()}, tokens=jnp.asarray(toks)))
    assert x.rel(ours.numpy(), np.asarray(ref)) <= 0.1
    if case == "seamless":
        src = ex["src_embeds"]
        assert x.rel(model._encode(ready, torch.from_numpy(src)).numpy(),
                     JModel(cfg)._encode(jp, jnp.asarray(src))) <= 1e-5
