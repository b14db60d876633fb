"""PyTorch port: the dual-microbatch overlap (``parallel/overlap.py``)
against the JAX reference on the CPU, one device.

* ``ServeEngine(decode_overlap=True)`` on the dense ring (4 slots): the
  greedy streams of smoke qwen3-14b and smoke DeepSeek-V3 (MoE; its MTP
  module carried, not drafting) equal the JAX engine's
  ``decode_overlap=True`` streams and the port's own single path, token
  for token (the reference's ``TestDecodeOverlap``).
* The schedule, from ``collectives.record()``: each layer's attention runs
  for half A, then half B, before the next layer's.
* ``Model.loss_dual`` against JAX's ``loss_dual`` on halves with uneven
  pad counts (the reference's ``TestDualLossEquivalence``), smoke
  DeepSeek-V3 (MLA + MoE + MTP, FP8 off) and smoke qwen3-14b: loss and
  metrics within 1e-5, every gradient leaf within 1e-4 of its largest
  reference magnitude; the CE within 1e-5 of the port's ``Model.loss``
  on the joined batch (the loss too without MTP: the MTP term's weights
  are the CE's valid fractions, as in the reference).
* ``decode_loop(overlap=True)``'s refusals, with the reference's words,
  and ``loss_dual`` under a mesh.

The meshed dual decode (all-to-alls in flight under the other half) is
held in ``tests/test_torch_serve_mesh.py``. About 30 s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models.api import Model
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.context import Mesh, ParallelCtx, use
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optimizer as optim

ARCHS = {"qwen": "qwen3-14b", "dsv3": "deepseek-v3-671b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this test process (the suite runs files in
    parallel workers on one CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    """The smoke config of both packages, MoE capacity 8.0 (no drops, so
    per-token routing decides every stream) and ``kw`` replaced."""
    out = []
    for cfg in (smoke_config(get_config(arch)), tsmoke(tget(arch))):
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _prompts(vocab):
    return [np.arange(4 + i * 3) * (i + 3) % vocab for i in range(5)]


def _serve(eng, request_cls):
    reqs = [request_cls(i, p, max_new=6)
            for i, p in enumerate(_prompts(eng.cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [list(map(int, r.out)) for r in reqs]


@pytest.fixture(scope="module", params=sorted(ARCHS))
def served(request):
    cfg, tcfg = _configs(ARCHS[request.param])
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    kw = dict(slots=4, max_len=32, seed=0, chunk=4)
    ref = _serve(JServeEngine(cfg, params=jp, decode_overlap=True, **kw),
                 JRequest)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    single = ServeEngine(tcfg, params=tp, device="cpu", **kw)
    dual = ServeEngine(tcfg, params=tp, decode_overlap=True, device="cpu",
                       **kw)
    return dict(ref=ref, single=_serve(single, Request),
                dual=_serve(dual, Request), engine=dual)


def test_dual_decode_streams_equal_jax_and_the_single_path(served):
    assert served["dual"] == served["ref"], (served["dual"], served["ref"])
    assert served["dual"] == served["single"]


def test_each_layer_runs_both_halves_before_the_next(served):
    """The record of one dual decode step: the attention marks go layer
    by layer, A then B; on one device nothing is in flight, so no
    collective is issued."""
    eng = served["engine"]
    m = eng.model
    state = m.init_decode_state(eng.slots)
    with coll.record() as rec:
        m.decode_loop(eng.params, eng.cache, state, 1, overlap=True)
    layers = [f"{s.name}/{i}" for s in m.segments for i in range(s.n)]
    marks = [(e.layer, e.half) for e in rec.entries if e.event == "mark"]
    assert marks == [(name, h) for name in layers for h in "AB"], marks
    assert not rec.collectives()
    with coll.record() as rec:
        m.decode_loop(eng.params, eng.cache, state, 1)
    assert [(e.layer, e.half) for e in rec.entries] == [
        (name, None) for name in layers]


# (arch, fp8) of the dual-loss cases: both without FP8 (FP8's code flips
# would need wider tolerances, tests/test_torch_train.py)
LOSS_CASES = {"dsv3": ("deepseek-v3-671b", dict(fp8=False)),
              "qwen": ("qwen3-14b", {})}


def _uneven_batch(vocab):
    """The reference test's batch: 4 x 16 tokens, rows 0-1 with only 3
    valid labels, so the halves' valid-token counts differ."""
    g = np.random.default_rng(27)
    toks = g.integers(0, vocab, (4, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:2, 3:] = -1
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def _halves(batch):
    return ({k: v[:2] for k, v in batch.items()},
            {k: v[2:] for k, v in batch.items()})


@pytest.fixture(scope="module", params=sorted(LOSS_CASES))
def loss_case(request):
    arch, kw = LOSS_CASES[request.param]
    cfg, tcfg = _configs(arch, **kw)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(1))
    batch = _uneven_batch(cfg.vocab_size)
    bA, bB = _halves({k: jnp.asarray(v) for k, v in batch.items()})
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_dual, has_aux=True))(
        jp, bA, bB)
    npp = jax.tree.map(np.asarray, jp)
    return dict(tcfg=tcfg, npp=npp, batch=batch, loss=float(jl),
                metrics=jax.tree.map(np.asarray, jmet),
                grads=jax.tree.map(np.asarray, jg))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _port_loss_dual(case):
    tp = bridge.params_from_jax(case["npp"])
    items = optim.tree_items(tp)
    for _, t in items:
        t.requires_grad_(True)
    bA, bB = _halves({k: torch.from_numpy(v)
                      for k, v in case["batch"].items()})
    model = Model(case["tcfg"], device="cpu")
    loss, metrics = model.loss_dual(tp, bA, bB)
    grads = torch.autograd.grad(loss, [t for _, t in items],
                                allow_unused=True)
    return model, tp, loss, metrics, dict(zip([p for p, _ in items], grads))


def test_loss_dual_matches_jax_and_the_single_loss(loss_case):
    model, tp, loss, metrics, grads = _port_loss_dual(loss_case)
    loss = float(loss.detach())
    ref = loss_case["loss"]
    assert abs(loss - ref) <= 1e-5 * abs(ref), (loss, ref)
    want = loss_case["metrics"]
    assert sorted(metrics) == sorted(want)
    for k, v in want.items():
        assert _rel(metrics[k].detach().numpy(), v) <= 1e-5, k
    # the CE equals the joined batch's; with MTP the loss does only for
    # halves of equal valid proportions (overlap.dual_loss_and_metrics),
    # which these uneven pads are not
    single, smet = model.loss(tp, {k: torch.from_numpy(v)
                                   for k, v in loss_case["batch"].items()})
    assert _rel(metrics["ce"], smet["ce"]) <= 1e-5
    if not loss_case["tcfg"].mtp:
        assert abs(float(single.detach()) - loss) <= 1e-5 * abs(loss)
    want_grads = dict(optim.tree_items(loss_case["grads"]))
    assert sorted(grads) == sorted(want_grads)
    worst = {}
    for path, g in grads.items():
        want_g = want_grads[path]
        if g is None:
            # the router bias selects experts only: JAX's gradient is 0
            assert path[-1] == "bias" and not np.any(want_g), path
            continue
        worst[path] = _rel(g, want_g)
    bad = {p: e for p, e in worst.items() if e > 1e-4}
    assert not bad, bad


def test_overlap_refusals_use_the_reference_words():
    cfg = tsmoke(tget("deepseek-v3-671b"))
    m = Model(cfg, device="cpu")
    p = bridge.prepare_for_serving(m.init(0), cfg)
    state = m.init_decode_state(4)
    dense = m.init_cache(4, 16)
    with pytest.raises(ValueError, match="use_mtp"):
        m.decode_loop(p, dense, state, 1, overlap=True, use_mtp=True)
    with pytest.raises(ValueError, match="even batch"):
        m.decode_loop(p, m.init_cache(3, 16), m.init_decode_state(3), 1,
                      overlap=True)
    with pytest.raises(ValueError, match="dense cache"):
        m.decode_loop(p, m.init_paged_cache(4, 16, 8, 8), state, 1,
                      overlap=True)
    with pytest.raises(ValueError, match="decoder-only"):
        m.decode_loop(p, dict(dense, memory=torch.zeros(4, 1, 8)), state,
                      1, overlap=True)
    with use(ParallelCtx(mesh=Mesh.abstract((1, 2)))):
        with pytest.raises(ValueError, match="no process group"):
            m.loss_dual(m.init(0), *_halves(_uneven_batch(cfg.vocab_size)))
