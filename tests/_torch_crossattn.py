"""The harness of ``test_torch_archs_encdec.py`` and
``test_torch_archs_vision.py``: the two families with a memory —
seamless-m4t-large-v2 (enc-dec: an encoder over frame embeddings, decoder
blocks that cross-attend to its output) and llama-3.2-vision-90b (gated
cross-attention over patch embeddings) — at smoke width in fp32, through
the JAX ``ServeEngine`` (its registry's ``ref`` backend) and the port's,
on the same weights (``bridge.params_from_jax``), greedy.

The vision gates ``gate_attn`` and ``gate_mlp`` start at zero (the
reference's init), so ``tanh(0)`` would make every cross layer add
nothing: :func:`weights` sets them from a seeded normal in the numpy tree
before it goes to either package.

``max_len`` 64 gives seamless a memory leaf of ``int(64 * 0.25)`` = 16
rows. Its requests carry 6, 13 and 16 frames: the shorter ones are
zero-padded into the leaf at admission, and decode attends over every row
of it, as the reference does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import _torch_archs as h
from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.serve.engine import Request, ServeEngine

CASES = {"seamless": "seamless-m4t-large-v2",
         "vision": "llama-3.2-vision-90b"}
MODES = h.MODES
KW = dict(slots=2, max_len=64, seed=0, chunk=4, page_size=8)
LENGTHS = (5, 11, 17)
FRAMES = (6, 13, 16)
MAX_NEW = 6


def configs(case, kernel_path=False):
    """(JAX cfg, port cfg) of ``case`` at smoke width."""
    arch = CASES[case]
    impl = "pallas" if kernel_path else "ref"
    return tuple(dataclasses.replace(c, fp8_impl=impl) for c in
                 (smoke_config(get_config(arch)), tsmoke(tget(arch))))


_WEIGHTS = {}


def weights(case):
    """The JAX init of ``case``'s smoke config, its vision gates drawn
    non-zero, as (JAX tree, numpy tree); made once a process."""
    if case not in _WEIGHTS:
        cfg, _ = configs(case)
        npp = jax.tree.map(np.asarray,
                           jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0)))
        if cfg.family == "vlm":
            rng = np.random.default_rng(11)
            cross = npp["pat"]["cross"]
            for g in ("gate_attn", "gate_mlp"):
                cross[g] = rng.normal(size=cross[g].shape).astype(
                    cross[g].dtype)
        _WEIGHTS[case] = (jax.tree.map(jnp.asarray, npp), npp)
    return _WEIGHTS[case]


def port_params(case):
    return bridge.params_from_jax(weights(case)[1])


def extras(cfg, i, batch=1):
    """Request ``i``'s seeded frames (enc-dec, ``FRAMES[i]`` of them) or
    patches (vision, ``num_patches``): numpy, (batch, rows, d_model)."""
    rng = np.random.default_rng(100 + i)
    if cfg.family == "encdec":
        rows, key = FRAMES[i % len(FRAMES)], "src_embeds"
    else:
        rows, key = cfg.num_patches, "patch_embeds"
    return {key: (0.5 * rng.normal(size=(batch, rows, cfg.d_model)))
            .astype(np.float32)}


def prompts(vocab):
    return [np.arange(L) * (i + 3) % vocab for i, L in enumerate(LENGTHS)]


def requests(port, vocab, max_new=MAX_NEW, priorities=None):
    cls = Request if port else JRequest
    return [cls(i, p, max_new=max_new,
                priority=0 if priorities is None else priorities[i])
            for i, p in enumerate(prompts(vocab))]


def engine(case, port, mode="dense", kernel_path=False, **kw):
    """The JAX engine or the port's on ``case``'s weights, in ``mode``
    (``_torch_archs.MODES``)."""
    cfg, tcfg = configs(case, kernel_path)
    kw = dict(KW, **MODES[mode], **kw)
    attn = "pallas" if kernel_path else ""
    if port:
        return ServeEngine(tcfg, params=port_params(case), attn_impl=attn,
                           device="cpu", **kw)
    return JServeEngine(cfg, params=weights(case)[0], attn_impl=attn, **kw)


def submit_all(eng, reqs):
    cfg = eng.cfg
    for r in reqs:
        eng.submit(r, extras(cfg, r.rid))


def summary(eng, reqs):
    return dict(streams=[list(map(int, r.out)) for r in reqs],
                done=[r.done for r in reqs],
                stats={k: v for k, v in eng.stats.items()
                       if k != "dispatches"})


def streams(case, port, mode="dense", kernel_path=False, **kw):
    """Every request with its extras, run to the end: the summary."""
    with kernels.use_backend("ref"):
        eng = engine(case, port, mode, kernel_path, **kw)
        reqs = requests(port, eng.cfg.vocab_size)
        submit_all(eng, reqs)
        eng.run_until_done()
    assert all(r.done for r in reqs)
    return summary(eng, reqs)


def rel(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def check_counts(case, full_count):
    """At full size, nothing allocated: every parameter's shape, dtype,
    axes and initializer equal to the reference's (the vision gates'
    "zeros" among them), ``count_params`` equal at full size and at smoke
    width."""
    import torch  # noqa: F401  (the port's modules need it imported)
    from repro.models.api import count_params as jcount_params
    from repro_torch.models.api import Model, count_params
    from repro_torch.models.param import ParamSpec
    arch = CASES[case]
    cfg, tcfg = get_config(arch), tget(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    want = h.flat(JModel(cfg).specs())
    got = h.flat(Model(tcfg, device="meta").specs())
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert isinstance(spec, ParamSpec)
        assert (tuple(spec.shape), spec.axes, spec.init, spec.scale) == (
            tuple(want[path].shape), want[path].axes, want[path].init,
            want[path].scale), path
        assert np.dtype(spec.dtype) == np.dtype(want[path].dtype), path
    assert count_params(tcfg) == jcount_params(cfg) == full_count
    scfg, stcfg = configs(case)
    assert count_params(stcfg) == jcount_params(scfg)


def check_logits(case, B=2, S=16, extra=8):
    """A bucketed prefill (rows of 9 and 16 real tokens) with extras into
    rings ``extra`` rows longer, every cache leaf it assembles (ring rows
    past a row's length compared where valid: the reference's vision
    rings keep the pad tokens' K/V there, behind ``pos`` -1, where the
    port's hold zeros), then three decode steps over them: logits within
    1e-5 of the largest."""
    import torch
    from repro_torch.models.api import Model
    jp, npp = weights(case)
    cfg, tcfg = configs(case)
    jm = JModel(cfg)
    model = Model(tcfg, device="cpu")
    tp = bridge.prepare_for_serving(port_params(case), tcfg)
    V = cfg.vocab_size
    toks = np.zeros((B, S), np.int32)
    toks[0, :9] = np.arange(9) * 7 % V
    toks[1] = np.arange(S) * 5 % V
    lengths = np.asarray([9, S], np.int32)
    ex = extras(cfg, 0, batch=B)
    jpre = jax.jit(lambda p, t, n, e: jm.prefill(
        p, dict(e, tokens=t), extra_slots=extra, lengths=n))
    ref, jcache = jpre(jp, jnp.asarray(toks), jnp.asarray(lengths),
                       {k: jnp.asarray(v) for k, v in ex.items()})
    ours, cache = model.prefill(tp, dict(ex, tokens=torch.from_numpy(toks)),
                                extra_slots=extra, lengths=lengths)
    assert rel(ours.numpy(), ref) <= 1e-5
    want = h.flat(jax.tree.map(np.asarray, jcache))
    got = h.flat(bridge.to_numpy(cache))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        if path[-1] == "pos":
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
        elif path[-1] in ("k", "v"):
            valid = want[path[:-1] + ("pos",)] >= 0
            m = valid.reshape(valid.shape + (1, 1))
            assert rel(np.where(m, got[path], 0),
                       np.where(m, leaf, 0)) <= 1e-5, path
        else:
            assert rel(got[path], leaf) <= 1e-5, path
    step = jax.jit(jm.decode_step)
    tok = np.asarray([[3], [9]], np.int32)
    pos = lengths[:, None].copy()
    for _ in range(3):
        ref, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        ours, cache = model.decode_step(tp, cache, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        ref = np.asarray(ref)
        assert rel(ours.numpy(), ref) <= 1e-5
        tok = ref.argmax(-1).astype(np.int32)
        pos = pos + 1


def check_loss_and_grads(case):
    """``Model.loss`` on a batch with its extras within 1e-5 of the
    reference's, and every gradient leaf within 1e-4 of its largest
    reference magnitude (``jax.value_and_grad``)."""
    import torch
    from repro.data.pipeline import SyntheticCorpus
    from repro_torch.models.api import Model
    from repro_torch.train import optimizer as optim
    jp, _ = weights(case)
    cfg, tcfg = configs(case)
    batch = dict(SyntheticCorpus(cfg.vocab_size, 16, 2, seed=3).batch_at(0),
                 **extras(cfg, 1, batch=2))
    (jl, jmet), jg = jax.jit(jax.value_and_grad(JModel(cfg).loss,
                                                has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = port_params(case)
    items = optim.tree_items(tp)
    for _, t in items:
        t.requires_grad_(True)
    loss, metrics = Model(tcfg, device="cpu").loss(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in items])
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert sorted(metrics) == sorted(jmet)
    want = dict(optim.tree_items(jax.tree.map(np.asarray, jg)))
    assert sorted(p for p, _ in items) == sorted(want)
    bad = {path: rel(g, want[path]) for (path, _), g in zip(items, grads)
           if rel(g, want[path]) > 1e-4}
    assert not bad, bad
    return {path: float(np.abs(want[path]).max()) for path, _ in items}
