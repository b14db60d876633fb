"""PyTorch port: the five decoder-only transformer configs it gained beside
DeepSeek-V3 and qwen3-14b — glm4-9b (32 heads over 2 KV heads, QKV bias),
qwen1.5-4b (MHA, QKV bias), yi-34b (56 over 8), qwen3-moe-30b-a3b (128
experts, softmax routing, 4 of 8 groups) and llama4-maverick (the
``interleave:2`` dense/MoE pairs, top-1 routing plus a shared expert) —
against the JAX package on the CPU.

* At full size, nothing allocated: every parameter's shape and dtype equal
  to the reference's ``param_structs()``, ``count_params`` (total and
  active) equal to the reference's.
* ``route()`` at smoke width and at the published 128 experts:
  ``expert_idx`` and ``load`` equal, weights within 1e-6, the scores
  within 1e-5 of the largest (the gate's fp32 sums in another order).
* ``moe_ffn`` (capacity dispatch, shared expert) within 1e-5 of the
  largest output, the drop fraction equal.
* At smoke width (fp32), weights from the JAX ``Model.init`` through
  ``bridge.params_from_jax``: bucketed prefill logits and dense-ring
  decode-step logits within 1e-5 of max|logit|; ``Model.loss`` within
  1e-5 relative and every gradient leaf within 1e-4 of its largest
  reference magnitude (``jax.value_and_grad``), the MoE loads equal.

The engines' streams are in ``test_torch_archs_serve.py``,
``test_torch_archs_paged.py``, ``test_torch_archs_moe.py`` and
``test_torch_archs_llama4.py``; llama4's nested page pools in
``test_torch_archs_pairs.py``.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_archs as h
from repro.configs.base import get_config, smoke_config
from repro.configs.base import list_archs as jlist_archs
from repro.core import moe as jmoe
from repro.core import routing as jrouting
from repro.data.pipeline import SyntheticCorpus
from repro.models.api import Model as JModel
from repro.models.api import count_params as jcount_params
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import list_archs
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import moe, routing
from repro_torch.models.api import Model, count_params
from repro_torch.models.param import ParamSpec
from repro_torch.train import optimizer as optim

ARCHS = ("glm4-9b", "qwen1.5-4b", "yi-34b", "qwen3-moe-30b-a3b",
         "llama4-maverick-400b-a17b")
MOE_ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
# tests/test_system.py's nominal ranges
NOMINAL = {"yi-34b": (32e9, 36e9), "qwen3-moe-30b-a3b": (29e9, 32e9),
           "llama4-maverick-400b-a17b": (380e9, 420e9)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this test process: the suite runs files in
    parallel workers, and a thread per core in each oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


# ---------------------------------------------------------------------------
# Full configs: specs and counts, nothing allocated
# ---------------------------------------------------------------------------


def test_list_archs_holds_the_seven_decoder_only_transformers():
    """The seven decoder-only transformers, and beside them the two
    recurrent families (``test_torch_archs_recurrent.py``) and the enc-dec
    and vision families (``test_torch_archs_encdec.py``,
    ``test_torch_archs_vision.py``): all 11 of the reference's."""
    assert list_archs() == sorted(ARCHS + ("deepseek-v3-671b", "qwen3-14b",
                                           "mamba2-2.7b",
                                           "recurrentgemma-9b",
                                           "seamless-m4t-large-v2",
                                           "llama-3.2-vision-90b"))
    assert list_archs() == jlist_archs()
    for arch in ARCHS:
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(
            get_config(arch)), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_counts_equal_the_reference(arch):
    cfg, tcfg = get_config(arch), tget(arch)
    want = h.flat(JModel(cfg).param_structs())
    got = h.flat(Model(tcfg, device="meta").specs())
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert isinstance(spec, ParamSpec)
        assert tuple(spec.shape) == tuple(want[path].shape), path
        assert np.dtype(spec.dtype) == want[path].dtype, path
    for active in (False, True):
        assert count_params(tcfg, active) == jcount_params(cfg, active)
    if arch in NOMINAL:
        lo, hi = NOMINAL[arch]
        assert lo < count_params(tcfg) < hi
    if arch.startswith("llama4"):
        # the dense half of each pair at d_ff, the MoE half's experts and
        # shared expert at expert_ff = shared_ff
        pat = got
        assert pat[("pat", "dense", "mlp", "w_gate")].shape[-1] == 16384
        assert pat[("pat", "moe", "moe", "w1")].shape == (24, 128, 5120,
                                                          8192)
        assert pat[("pat", "moe", "moe", "ws1")].shape[-1] == 8192


# ---------------------------------------------------------------------------
# Routing and the MoE layer
# ---------------------------------------------------------------------------


ROUTE_CASES = [(a, w) for a in MOE_ARCHS for w in ("smoke", "full")]


@pytest.mark.parametrize("arch,width", ROUTE_CASES)
def test_route_matches_jax(arch, width):
    """qwen3-moe: softmax, top-8 from 4 of 8 groups (smoke: top-2 from 2
    of 4), ``route_norm``; llama4: sigmoid, top-1 with ``group_top`` 1, no
    renormalization; no router bias on either."""
    cfg = get_config(arch)
    if width == "smoke":
        cfg = smoke_config(cfg)
    tcfg = tget(arch) if width == "full" else tsmoke(tget(arch))
    assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(cfg.moe)
    assert not cfg.moe.router_bias
    g = _gen(("route", arch, width))
    x = g.standard_normal((48, cfg.d_model)).astype(np.float32)
    w = (g.standard_normal((cfg.d_model, cfg.moe.num_experts))
         / np.sqrt(cfg.d_model)).astype(np.float32)
    ref = jrouting.route(jnp.asarray(x), jnp.asarray(w), cfg.moe)
    rr = routing.route(torch.from_numpy(x), torch.from_numpy(w), tcfg.moe)
    np.testing.assert_array_equal(rr.expert_idx.numpy(),
                                  np.asarray(ref.expert_idx))
    assert np.abs(rr.weights.numpy() - np.asarray(ref.weights)).max() <= 1e-6
    # the gate's fp32 sums over d_model run in another order: a few ulps
    assert _rel(rr.scores, ref.scores) <= 1e-5
    np.testing.assert_array_equal(rr.load.numpy(), np.asarray(ref.load))
    assert _rel(rr.aux_loss, ref.aux_loss) <= 1e-6
    m = routing.groups_per_token(rr.expert_idx, tcfg.moe).numpy()
    np.testing.assert_array_equal(
        m, np.asarray(jrouting.groups_per_token(ref.expert_idx, cfg.moe)))
    assert m.max() <= cfg.moe.group_limit
    if cfg.moe.route_norm:
        np.testing.assert_allclose(rr.weights.sum(-1).numpy(), 1.0,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch):
    """The capacity dispatch at the arch's ``top_k`` (llama4: 1, with its
    shared expert) on a batch whose tokens overflow some experts, and the
    capacities of decode and prefill token counts."""
    cfg, tcfg = smoke_config(get_config(arch)), tsmoke(tget(arch))
    for T in (1, 4, 37, 256, 2048):
        assert moe.capacity(T, tcfg.moe) == jmoe.capacity(T, cfg.moe)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a[0], jp["blocks" if "blocks" in jp
                                        else "pat"])
    p = p["moe"]["moe"] if "dense" in p else p["moe"]
    g = _gen(("moe", arch))
    # tokens sharing one direction crowd a few experts past capacity
    x = (g.standard_normal((2, 40, cfg.d_model)) * 0.5
         + g.standard_normal((cfg.d_model,)) * 2).astype(np.float32)
    y, rr, drop = jax.jit(lambda p_, x_: jmoe.moe_ffn(p_, x_, cfg))(
        p, jnp.asarray(x))
    ty, trr, tdrop = moe.moe_ffn(
        bridge.params_from_jax(jax.tree.map(np.asarray, p)),
        torch.from_numpy(x), tcfg)
    assert _rel(ty, y) <= 1e-5
    np.testing.assert_array_equal(trr.expert_idx.numpy(),
                                  np.asarray(rr.expert_idx))
    assert float(tdrop) == pytest.approx(float(drop), abs=1e-7)
    assert float(drop) > 0            # the capacity contest ran
    assert ("ws1" in p) == arch.startswith("llama4")


# ---------------------------------------------------------------------------
# Logits, loss and gradients at smoke width
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    arch = request.param
    cfg, tcfg = smoke_config(get_config(arch)), tsmoke(tget(arch))
    jm = JModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    return dict(arch=arch, cfg=cfg, tcfg=tcfg, jm=jm, jp=jp, npp=npp)


def test_prefill_and_decode_logits_match_jax(smoke):
    """A bucketed prefill (a 16-wide bucket, 11 real tokens) into rings 4
    rows longer, then two decode steps over them."""
    jm, jp, tcfg = smoke["jm"], smoke["jp"], smoke["tcfg"]
    V = smoke["cfg"].vocab_size
    model = Model(tcfg, device="cpu")
    tp = bridge.prepare_for_serving(bridge.params_from_jax(smoke["npp"]),
                                    tcfg)
    toks = np.zeros((2, 16), np.int32)
    toks[0, :11] = np.arange(11) * 7 % V
    toks[1] = np.arange(16) * 5 % V
    lengths = np.asarray([11, 16], np.int32)
    jpre = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t},
                                              extra_slots=4, lengths=n))
    ref, jcache = jpre(jp, jnp.asarray(toks), jnp.asarray(lengths))
    ours, cache = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                extra_slots=4, lengths=lengths)
    ref = np.asarray(ref)
    assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    jstep = jax.jit(jm.decode_step)
    tok = np.asarray([[3], [9]], np.int32)
    pos = lengths[:, None].copy()
    for _ in range(2):
        ref, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        ours, cache = model.decode_step(tp, cache, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        ref = np.asarray(ref)
        assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        tok = ref[:, :, :].argmax(-1).astype(np.int32)
        pos = pos + 1
    if smoke["arch"].startswith("llama4"):
        assert sorted(cache["pat"]) == ["dense", "moe"]
        assert cache["pat"]["moe"]["k"].shape == (2, 2, 20, 4, 32)


@pytest.fixture(scope="module")
def loss_case(smoke):
    jm = smoke["jm"]
    batch = SyntheticCorpus(smoke["cfg"].vocab_size, 32, 4,
                            seed=3).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        smoke["jp"], {k: jnp.asarray(v) for k, v in batch.items()})
    tp = bridge.params_from_jax(smoke["npp"])
    items = optim.tree_items(tp)
    for _, t in items:
        t.requires_grad_(True)
    loss, metrics = Model(smoke["tcfg"], device="cpu").loss(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in items],
                                allow_unused=True)
    return dict(loss=(float(loss.detach()), float(jl)),
                metrics=(metrics, jax.tree.map(np.asarray, jmet)),
                grads=(dict(zip([p for p, _ in items], grads)),
                       dict(optim.tree_items(jax.tree.map(np.asarray, jg)))))


def test_loss_and_metrics_match_jax(smoke, loss_case):
    ours, ref = loss_case["loss"]
    assert abs(ours - ref) <= 1e-5 * abs(ref)
    metrics, want = loss_case["metrics"]
    assert sorted(metrics) == sorted(want)
    for k, v in want.items():
        got = metrics[k].detach().numpy()
        if k.endswith("load_layers") or k == "ntokens":
            np.testing.assert_array_equal(got, v, err_msg=k)
        elif k.endswith("drop_frac"):
            assert abs(float(got) - float(v)) <= 1e-6 * max(abs(float(v)),
                                                            1e-6), k
        else:
            assert abs(float(got) - float(v)) <= 1e-5 * max(
                abs(float(v)), 1e-30), k
    assert (any(k.endswith("load_layers") for k in want)
            == (smoke["arch"] in MOE_ARCHS))


def test_every_gradient_leaf_matches_jax(smoke, loss_case):
    grads, want = loss_case["grads"]
    assert sorted(grads) == sorted(want)
    bad = {}
    for path, g in grads.items():
        assert g is not None, path        # no router bias on these archs
        err = _rel(g, want[path])
        if err > 1e-4:
            bad[path] = err
    assert not bad, bad
