"""PyTorch port: MTP drafting (``core/mtp.py``, the MTP ring at prefill,
``decode_loop(use_mtp=True)``) on the dense and the paged-fp8 engine
against the JAX reference (``repro.core.mtp``, ``repro.serve.engine``).

Weights are the JAX ``Model.init`` tree of smoke DeepSeek-V3 copied
through ``bridge.params_from_jax``; inputs come from numpy seeds. Token
streams and draft/acceptance counts must be equal; hidden states and
rings within 1e-5 of the largest reference magnitude (fp32 sums in
another order; the smoke MTP projection runs on the FP8 path in both
packages, with the same quantization).
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
from repro.core import mtp as jmtp
from repro.models import transformer as jtfm
from repro.models.api import Model as JModel
from repro.serve import speculative as jspec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import fp8, mtp
from repro_torch.models import transformer as tfm
from repro_torch.models.api import Model
from repro_torch.models.param import layer
from repro_torch.serve import speculative
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_thread  # noqa: F401


RTOL = 1e-5


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _close(a, b, rtol=RTOL):
    a = a.detach().float().numpy()
    b = np.asarray(jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= rtol * max(float(np.abs(b).max()), 1e-30), err


@pytest.fixture(scope="module")
def dsv3():
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))  # jitted: faster
    return cfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def test_mtp_hidden_matches_reference(dsv3):
    """One MTP module over a short sequence (no cache): the projection on
    the FP8 path, the dense block, the same output."""
    cfg, tcfg, _, npp = dsv3
    g = _gen("mtp_hidden")
    h = g.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    e = g.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    jpm = jax.tree.map(lambda v: jnp.asarray(v[0]), npp["mtp"])
    ref = jmtp.mtp_hidden(
        jpm, jnp.asarray(h), jnp.asarray(e), cfg=cfg,
        positions=jnp.asarray(pos),
        block_apply=lambda p, x, q: jtfm.block_apply(
            p, x, cfg, dict(positions=q, causal=True), None)[0])
    tp = bridge.prepare_for_serving(bridge.params_from_jax(npp), tcfg)
    ours = mtp.mtp_hidden(
        layer(tp["mtp"], 0), torch.from_numpy(h), torch.from_numpy(e),
        cfg=tcfg, positions=torch.from_numpy(pos),
        block_apply=lambda p, x, q: tfm.block_apply(
            p, x, tcfg, dict(positions=q), None)[0])
    _close(ours, ref)


def test_prepare_for_serving_quantizes_the_mtp_linears(dsv3):
    _, tcfg, _, npp = dsv3
    tp = bridge.prepare_for_serving(bridge.params_from_jax(npp), tcfg)
    assert isinstance(tp["mtp"]["w_proj"], fp8.Fp8Weight)      # 2d = 256
    assert isinstance(tp["mtp"]["block"]["mlp"]["w_down"], fp8.Fp8Weight)
    assert isinstance(tp["mtp"]["norm_h"], torch.Tensor)


def test_mtp_align_head_matches_reference(dsv3):
    _, _, jp, npp = dsv3
    ref = jax.tree.map(np.asarray, jmtp.mtp_align_head(jp)["mtp"])
    ours = mtp.mtp_align_head(bridge.params_from_jax(npp))["mtp"]
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat:
        t = ours
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), leaf)
    with pytest.raises(ValueError, match="before"):
        mtp.mtp_align_head({"prepared": True})


def test_prefill_ring_and_first_draft_match_reference(dsv3):
    """``prefill`` with MTP: ``mtp_h`` is the last real position's hidden
    and the MTP ring holds the module's entries over the prompt's pairs, in
    a ring of S + extra_slots rows, -1 past the last real pair. The first
    decode step's draft (``mtp_draft_tokens``) then picks the reference's
    token and writes the same ring row. FP8 off on both sides: under jit,
    XLA rewrites the reference's ``amax / 448`` and moves FP8 scales by an
    ulp (the FP8 path is held by the other tests, eagerly)."""
    cfg, tcfg, jp, npp = dsv3
    cfg = dataclasses.replace(cfg, fp8=False)
    tcfg = dataclasses.replace(tcfg, fp8=False)
    L, toks = 11, np.zeros((1, 16), np.int32)
    toks[0, :L] = np.arange(L) * 7 % cfg.vocab_size
    jm = JModel(cfg)
    jprefill = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t},
                                                  extra_slots=8, lengths=n))
    jdraft = jax.jit(lambda p, c, t, q: jmtp.mtp_draft_tokens(
        p, c, cfg, t, q, embed_fn=lambda x: jm._embed(p, x),
        unembed_fn=lambda h: jm._unembed(p, h)))
    with kernels.use_backend("ref"):
        jlogits, ref = jprefill(jp, jnp.asarray(toks), jnp.asarray([L]))
        first = int(jnp.argmax(jlogits[0, -1]))
        jd, jring = jdraft(jp, ref, jnp.asarray([first]), jnp.asarray([L]))
    model = Model(tcfg, device="cpu")
    tparams = bridge.prepare_for_serving(bridge.params_from_jax(npp), tcfg)
    _, ours = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            extra_slots=8, lengths=[L])
    _close(ours["mtp_h"], ref["mtp_h"])
    for k in ("ckv", "kr"):
        _close(ours["mtp"][k], ref["mtp"][k])
    np.testing.assert_array_equal(ours["mtp"]["pos"].numpy(),
                                  np.asarray(ref["mtp"]["pos"]))
    assert ours["mtp"]["pos"].shape == (1, 1, 24)
    assert int(ours["mtp"]["pos"].max()) == L - 2       # pairs 0..L-2

    draft = mtp.mtp_draft_tokens(
        tparams, ours, tcfg, torch.tensor([first]), torch.tensor([L]),
        embed_fn=lambda t: model._embed(tparams, t),
        unembed_fn=lambda h: model._unembed(tparams, h))
    assert int(draft[0]) == int(jd[0])
    for k in ("ckv", "kr"):                 # the pair at L-1, in place
        _close(ours["mtp"][k], jring[k])
    assert int(ours["mtp"]["pos"][0, 0, L - 1]) == L - 1


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs]


ENGINES = {"dense": dict(paged=False),
           "paged-fp8": dict(paged=True, page_size=8, page_storage="fp8")}


@pytest.mark.parametrize("layout", sorted(ENGINES))
def test_mtp_streams_drafts_and_acceptance_equal_jax(dsv3, layout):
    """``use_mtp=True`` with ``mtp_align_head`` (the draft is, up to the
    FP8 projection's rounding, the main model's previous greedy token),
    three requests on two slots: streams, draft and accepted counts equal
    the reference engine's, and acceptance is positive."""
    cfg, tcfg, jp, npp = dsv3
    kw = dict(slots=2, max_len=32, seed=0, chunk=4, use_mtp=True,
              **ENGINES[layout])
    # one prefill bucket (8) keeps the reference engine to two compiles
    prompts = [np.full(8, 7, np.int32),
               np.arange(6, dtype=np.int32) * 5 % cfg.vocab_size,
               np.tile(np.array([3, 9], np.int32), 4)]
    with kernels.use_backend("ref"):
        jeng = JServeEngine(cfg, params=jmtp.mtp_align_head(jp), **kw)
        ref = _run(jeng, [JRequest(i, p, max_new=8, seed=i)
                          for i, p in enumerate(prompts)])
    eng = ServeEngine(tcfg, params=mtp.mtp_align_head(
        bridge.params_from_jax(npp)), device="cpu", **kw)
    ours = _run(eng, [Request(i, p, max_new=8, seed=i)
                      for i, p in enumerate(prompts)])
    assert ours == ref
    assert eng.stats["drafts"] == jeng.stats["drafts"] == 3 * 7
    assert eng.stats["accepted_drafts"] == jeng.stats["accepted_drafts"]
    assert eng.acceptance_rate() > 0.0
    assert eng.free_pages() == (eng.pool_pages if eng.paged else 0)
    mine, theirs = speculative.measured(eng), jspec.measured(jeng)
    assert mine.tps_multiplier == theirs.tps_multiplier
    assert mine.model_layers == cfg.num_layers


def test_decode_loop_use_mtp_needs_an_mtp_module():
    cfg = tsmoke(tget("qwen3-14b"))
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="MTP"):
        model.decode_loop(model.init(0), model.init_cache(1, 8),
                          model.init_decode_state(1), 1, use_mtp=True)
