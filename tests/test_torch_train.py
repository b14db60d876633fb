"""PyTorch port: the training path against the JAX reference on the CPU —
``Model.loss`` (value, metrics, every gradient leaf) against
``jax.value_and_grad(Model.loss)``, routing's balancing diagnostics and
``update_bias``, ``mtp_losses``, and the AdamW update and the LR
schedule on identical numpy inputs. The trainer's trajectories are held
against the reference's in ``test_torch_train_infra.py``.

Weights are the JAX ``Model.init`` trees of the smoke configs (fp32),
copied through the bridge; batches are ``SyntheticCorpus`` batches. Each
JAX scenario runs once per module fixture, jitted as the reference runs
it.

Tolerances:

* Loss and gradients on paths without FP8 (smoke qwen3-14b; smoke
  DeepSeek-V3's MLA + MoE + MTP with ``fp8=False``): the loss within 1e-5
  relative, each gradient leaf within 1e-4 of its largest reference
  magnitude, the MoE loads equal and the drop fractions (a mean of equal
  per-layer drops) within 1e-6.
* With FP8 (smoke DeepSeek-V3 as published: MLA + MoE + MTP + FP8): an
  FP8 quantization is discontinuous, and the two packages' fp32 sums in
  another order (rmsnorm, attention, XLA's silu) move its inputs by an
  ulp, which now and then flips one E4M3 code; on this input one flip in
  the first block moves the loss by 4.6e-5 relative and gradient leaves by
  up to 3.1e-2 of their largest magnitude. Held at 2e-4 and 5e-2, with
  the MoE loads and drops as above. The FP8 backward itself is held at 1e-6
  in ``test_torch_fp8_grad.py``.
* ``mtp_losses`` on the same hidden states: 1e-6 relative.
* The optimizer on identical inputs: every leaf bit for bit without
  clipping; with clipping the global norm is an fp32 sum in another order
  (within 1e-6), its ulp moves the clip scale, and leaves may differ by
  two ulps of fp32. The schedule bit for bit against the reference
  evaluated eagerly (its jitted step computes cos one ulp off at some
  steps).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, smoke_config
from repro.core import mtp as jmtp
from repro.core import routing as jrouting
from repro.data.pipeline import SyntheticCorpus
from repro.models import transformer as jtfm
from repro.models.api import Model as JModel
from repro.train import optimizer as joptim
from repro.train import schedule as jsched
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import mtp, routing
from repro_torch.models import transformer as tfm
from repro_torch.models.api import Model
from repro_torch.train import optimizer as optim
from repro_torch.train import schedule as sched


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this test process: the suite runs files in
    parallel workers on one CPU, and torch's default of a thread per core
    in each worker oversubscribes it (these smoke shapes then run up to a
    hundred times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (arch, fp8) -> (loss rtol, gradient-leaf tol)
CASES = {"dsv3-fp8": ("deepseek-v3-671b", True, 2e-4, 5e-2),
         "dsv3-nofp8": ("deepseek-v3-671b", False, 1e-5, 1e-4),
         "qwen3-14b": ("qwen3-14b", False, 1e-5, 1e-4)}


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _configs(arch, use_fp8):
    cfg, tcfg = smoke_config(get_config(arch)), tsmoke(tget(arch))
    return (dataclasses.replace(cfg, fp8=cfg.fp8 and use_fp8),
            dataclasses.replace(tcfg, fp8=tcfg.fp8 and use_fp8))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def loss_case(request):
    arch, use_fp8, rtol, gtol = CASES[request.param]
    cfg, tcfg = _configs(arch, use_fp8)
    jm = JModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = SyntheticCorpus(cfg.vocab_size, 32, 4, seed=3).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(tcfg=tcfg, npp=_np(jp), batch=batch, loss=float(jl),
                metrics=_np(jmet), grads=_np(jg), rtol=rtol, gtol=gtol,
                moe=cfg.moe is not None)


def _port_loss(case):
    tp = bridge.params_from_jax(case["npp"])
    items = optim.tree_items(tp)
    for _, t in items:
        t.requires_grad_(True)
    model = Model(case["tcfg"], device="cpu")
    loss, metrics = model.loss(
        tp, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
    grads = torch.autograd.grad(loss, [t for _, t in items],
                                allow_unused=True)
    return loss, metrics, dict(zip([p for p, _ in items], grads))


def test_loss_and_metrics_match_jax(loss_case):
    loss, metrics, _ = _port_loss(loss_case)
    ref = loss_case["loss"]
    assert abs(float(loss.detach()) - ref) <= loss_case["rtol"] * abs(ref)
    want = loss_case["metrics"]
    assert sorted(metrics) == sorted(want)
    for k, v in want.items():
        got = metrics[k].detach().numpy()
        if k.endswith("load_layers") or k == "ntokens":
            np.testing.assert_array_equal(got, v, err_msg=k)
        elif k.endswith("drop_frac"):     # equal drops, a mean over layers
            assert abs(float(got) - float(v)) <= 1e-6 * abs(float(v)), k
        else:
            assert abs(float(got) - float(v)) <= loss_case["rtol"] * max(
                abs(float(v)), 1e-30), k
    assert (any(k.endswith("load_layers") for k in want)
            == loss_case["moe"])


def test_every_gradient_leaf_matches_jax(loss_case):
    _, _, grads = _port_loss(loss_case)
    want = dict(optim.tree_items(loss_case["grads"]))
    assert sorted(grads) == sorted(want)
    worst = {}
    for path, g in grads.items():
        if g is None:
            # the router bias selects experts only: JAX's gradient is 0
            assert path[-1] == "bias" and not np.any(want[path]), path
            continue
        worst[path] = _rel(g, want[path])
    bad = {p: e for p, e in worst.items() if e > loss_case["gtol"]}
    assert not bad, bad


def test_route_stats_and_update_bias_match_jax():
    cfg, tcfg = _configs("deepseek-v3-671b", True)
    g = _gen("route")
    x = g.standard_normal((40, cfg.d_model)).astype(np.float32)
    w = (g.standard_normal((cfg.d_model, cfg.moe.num_experts)) * 0.2
         ).astype(np.float32)
    bias = (g.standard_normal((cfg.moe.num_experts,)) * 0.01
            ).astype(np.float32)
    ref = jrouting.route(jnp.asarray(x), jnp.asarray(w), cfg.moe,
                         bias=jnp.asarray(bias))
    rr = routing.route(torch.from_numpy(x), torch.from_numpy(w), tcfg.moe,
                       bias=torch.from_numpy(bias))
    np.testing.assert_array_equal(rr.expert_idx.numpy(),
                                  np.asarray(ref.expert_idx))
    np.testing.assert_array_equal(rr.load.numpy(), np.asarray(ref.load))
    assert _rel(rr.aux_loss, ref.aux_loss) <= 1e-6
    np.testing.assert_array_equal(
        routing.groups_per_token(rr.expert_idx, tcfg.moe).numpy(),
        np.asarray(jrouting.groups_per_token(ref.expert_idx, cfg.moe)))
    assert routing.route(torch.from_numpy(x), torch.from_numpy(w),
                         tcfg.moe, stats=False).load is None
    # the trainer's call: a segment's stacked (n, E) bias and (n, E) loads
    stacked = np.stack([bias, -bias, bias * 3])
    loads = np.stack([np.asarray(ref.load), np.full(8, 0.125, np.float32),
                      np.full(8, 1 / 3, np.float32)])
    want = jrouting.update_bias(jnp.asarray(stacked), jnp.asarray(loads),
                                1e-3)
    got = routing.update_bias(torch.from_numpy(stacked),
                              torch.from_numpy(loads), 1e-3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mtp_losses_match_jax():
    cfg, tcfg = _configs("deepseek-v3-671b", True)
    jm = JModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tp = bridge.params_from_jax(_np(jp))
    model = Model(tcfg, device="cpu")
    g = _gen("mtp")
    B, S = 3, 20
    h = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    toks = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    ref = jax.jit(lambda p, hh, tt, pp: jmtp.mtp_losses(
        p["mtp"], hh, tt, emb_fn=lambda t: jm._embed(p, t),
        unemb_fn=lambda x: jm._unembed(p, x), cfg=cfg, positions=pp,
        block_apply=lambda q, x, positions: jtfm.block_apply(
            q, x, cfg, dict(positions=positions, causal=True), None)[0]))(
        jp, jnp.asarray(h), jnp.asarray(toks), jnp.asarray(pos))
    got = mtp.mtp_losses(
        tp["mtp"], torch.from_numpy(h), torch.from_numpy(toks),
        emb_fn=lambda t: model._embed(tp, t),
        unemb_fn=lambda hh: model._unembed(tp, hh), cfg=tcfg,
        positions=torch.from_numpy(pos),
        block_apply=lambda p, x, positions: tfm.block_apply(
            p, x, tcfg, dict(positions=positions), None)[0])
    assert _rel(got, ref) <= 1e-6


def _opt_inputs(tag):
    """A parameter tree (bf16 2-D, fp32 2-D, fp32 1-D leaves), its grads
    (one ``None`` in the port, zeros in JAX: a leaf without a gradient)
    and a state some steps in."""
    g = _gen(tag)
    shapes = {"a": {"w": (24, 40)}, "b": (64,), "bias": (3, 8),
              "g32": (16, 12)}
    dts = {"w": jnp.bfloat16, "b": jnp.float32, "bias": jnp.float32,
           "g32": jnp.float32}

    def tree(fn):
        return {"a": {"w": fn("w", shapes["a"]["w"])},
                **{k: fn(k, shapes[k]) for k in ("b", "bias", "g32")}}

    params = tree(lambda k, s: np.asarray(jnp.asarray(
        g.standard_normal(s) * 0.1, dts[k])))
    grads = tree(lambda k, s: np.asarray(jnp.asarray(
        g.standard_normal(s) * (0.0 if k == "bias" else 1e3), dts[k])))
    state = _np(joptim.init(jax.tree.map(jnp.asarray, params)))
    state = state._replace(
        step=np.asarray(6, np.int32),
        m=tree(lambda k, s: np.asarray(jnp.asarray(
            g.standard_normal(s) * 0.3, jnp.bfloat16))),
        v=tree(lambda k, s: np.asarray(jnp.asarray(
            np.abs(g.standard_normal(s)) * 0.5, jnp.bfloat16))))
    return params, grads, state


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("clip", [1.0, None])
def test_optimizer_update_matches_jax(clip):
    params, grads, state = _opt_inputs(("opt", clip))
    lr = np.float32(2.5e-3)
    jp, js, jst = joptim.update(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state),
        jax.tree.map(jnp.asarray, params), lr=jnp.asarray(lr),
        weight_decay=0.1, clip_norm=clip)
    tp, tstate = bridge.train_state_from_jax(params, state)
    tg = bridge.params_from_jax(grads)
    tg["bias"] = None
    tp, tstate, st = optim.update(tg, tstate, tp, lr=torch.tensor(lr),
                                  weight_decay=0.1, clip_norm=clip)
    assert int(tstate.step) == int(js.step)
    assert _rel(st["grad_norm"], jst["grad_norm"]) <= 1e-6
    for tree_t, tree_j in ((tp, jp), (tstate.master, js.master),
                           (tstate.m, js.m), (tstate.v, js.v)):
        want = dict(optim.tree_items(_np(tree_j)))
        for path, t in optim.tree_items(bridge.to_numpy(tree_t)):
            assert t.dtype == np.float32 or path
            assert _ulps(t, np.asarray(want[path], np.float32)) <= (
                0 if clip is None else 2), path
    assert tp["a"]["w"].dtype == torch.bfloat16
    assert tstate.m["b"].dtype == torch.bfloat16
    assert tstate.master["a"]["w"].dtype == torch.float32


@pytest.mark.parametrize("fn", ["warmup_cosine", "constant_with_warmup"])
def test_schedule_matches_jax_fp32(fn):
    kw = dict(peak_lr=3e-4, warmup=7)
    if fn == "warmup_cosine":
        kw["total"] = 50
    for step in range(60):
        want = np.float32(getattr(jsched, fn)(step, **kw))
        got = getattr(sched, fn)(step, **kw)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), (step, got, want)


# ---------------------------------------------------------------------------
# remat: the checkpointed layer steps (``models/api.remat``)
# ---------------------------------------------------------------------------


def _port_loss_under(case, policy, dual):
    """``Model.loss`` (or ``loss_dual`` on the batch's interleaved halves,
    as the trainer splits it) and every gradient leaf under
    ``ParallelCtx(remat=policy)``."""
    from repro_torch.parallel import context as C
    tp = bridge.params_from_jax(case["npp"])
    items = optim.tree_items(tp)
    leaves = [t.requires_grad_(True) for _, t in items]
    model = Model(case["tcfg"], device="cpu")
    b = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    with C.use(C.ParallelCtx(remat=policy)):
        if dual:
            loss, _ = model.loss_dual(tp, {k: v[0::2] for k, v in b.items()},
                                      {k: v[1::2] for k, v in b.items()})
        else:
            loss, _ = model.loss(tp, b)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), dict(zip([p for p, _ in items], grads))


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_keeps_loss_and_gradients_bitwise(loss_case, policy, dual):
    """Remat changes memory and recompute, never a value: under ``full``
    (each layer step checkpointed) and ``dots`` (the ``mm`` outputs kept,
    the rest recomputed) the loss and every gradient leaf equal
    ``remat="none"``'s bit for bit, on the single path and the dual
    microbatch."""
    loss0, g0 = _port_loss_under(loss_case, "none", dual)
    loss, g = _port_loss_under(loss_case, policy, dual)
    assert torch.equal(loss, loss0)
    assert sorted(g) == sorted(g0)
    for path, t in g.items():
        assert (t is None) == (g0[path] is None), path
        assert t is None or torch.equal(t, g0[path]), path


@pytest.fixture(scope="module", params=["full", "dots"])
def remat_case(request):
    """smoke DeepSeek-V3 without FP8 (MLA + MoE + MTP): JAX's loss and
    gradients under the reference's ``ParallelCtx(remat=...)``."""
    from repro.parallel import context as jctx
    arch, use_fp8, rtol, gtol = CASES["dsv3-nofp8"]
    cfg, tcfg = _configs(arch, use_fp8)
    jm = JModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = SyntheticCorpus(cfg.vocab_size, 32, 4, seed=3).batch_at(0)
    with jctx.use(jctx.ParallelCtx(remat=request.param)):
        (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(tcfg=tcfg, npp=_np(jp), batch=batch, loss=float(jl),
                grads=_np(jg), rtol=rtol, gtol=gtol, policy=request.param)


def test_remat_matches_jax_under_remat(remat_case):
    """The port under ``remat`` against ``jax.value_and_grad`` under the
    reference's same policy: the loss within 1e-5 relative, each gradient
    leaf within 1e-4 of its largest reference magnitude (the bounds of the
    unrematerialized comparison above)."""
    loss, grads = _port_loss_under(remat_case, remat_case["policy"], False)
    ref = remat_case["loss"]
    assert abs(float(loss) - ref) <= remat_case["rtol"] * abs(ref)
    want = dict(optim.tree_items(remat_case["grads"]))
    bad = {p: _rel(g, want[p]) for p, g in grads.items()
           if g is not None and _rel(g, want[p]) > remat_case["gtol"]}
    assert not bad, bad
