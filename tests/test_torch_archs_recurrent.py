"""PyTorch port: the recurrent families — mamba2-2.7b (Mamba-2 SSD) and
recurrentgemma-9b (RG-LRU blocks and sliding-window GQA in ``rg3``
patterns, at 5 layers also an ``rg_tail``) — against the JAX package on
the CPU, at smoke width in fp32 on ``bridge.params_from_jax`` weights.

* At full size, nothing allocated: every parameter's shape and dtype equal
  to the reference's, ``count_params`` equal (2 831 296 000 and
  10 444 984 320).
* Greedy streams of the dense engine equal the JAX engine's, on the
  default path and on the kernel path (``attn_impl="pallas"``, on which
  no registry op runs: the reference dispatches none for these families).
  The smoke window is 32: prompts of 40 and 50 tokens wrap the windowed
  ring in prefill, and one of 28 wraps it during decode.
* Bucketed prefill logits, every cache leaf it assembles and three decode
  steps' logits within 1e-5 of the largest.
* ``paged=True`` raises the reference's ``ValueError``; the unmeshed
  disaggregator hands the recurrent state over (the JAX engine's
  streams), and the meshed engine (its cache cut by heads or channels)
  and train step build.
* ``decode_overlap=True`` streams equal the JAX engine's; a decode keeps
  every cache leaf's tensor (the conv tails, the states, the rings).
* ``Model.loss`` within 1e-5 and every gradient leaf within 1e-4 of its
  largest reference magnitude (``jax.value_and_grad``).
* With ``fp8``, the load-time preparation gives the recurrent blocks'
  linears their ``Fp8Weight`` and never touches ``wa``, ``wi`` or
  ``conv_w`` (the FP8 engines' streams: ``test_torch_ssm.py``,
  ``test_torch_rglru.py``).

The blocks themselves, against the reference's functions:
``test_torch_ssm.py`` and ``test_torch_rglru.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_archs as h
from _torch_recurrent import (CASES, KW, MAX_NEW, configs, jax_streams,
                              port_engine, port_streams, prompts, weights)
from _torch_recurrent import rel as _rel
from repro.configs.base import get_config
from repro.data.pipeline import SyntheticCorpus
from repro.models.api import Model as JModel
from repro.models.api import count_params as jcount_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import fp8
from repro_torch.models.api import Model, count_params
from repro_torch.models.param import ParamSpec
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optimizer as optim

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
COUNTS = {"mamba2-2.7b": 2_831_296_000, "recurrentgemma-9b": 10_444_984_320}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Full configs: specs and counts, nothing allocated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_counts_equal_the_reference(arch):
    cfg, tcfg = get_config(arch), tget(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    want = h.flat(JModel(cfg).param_structs())
    got = h.flat(Model(tcfg, device="meta").specs())
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert isinstance(spec, ParamSpec)
        assert tuple(spec.shape) == tuple(want[path].shape), path
        assert np.dtype(spec.dtype) == want[path].dtype, path
    assert count_params(tcfg) == jcount_params(cfg) == COUNTS[arch]
    if arch == "recurrentgemma-9b":
        segs = [(s.kind, s.n, s.window) for s in Model(
            tcfg, device="meta").segments]
        assert segs == [("rg3", 12, 2048), ("rg_tail", 1, 0)]


# ---------------------------------------------------------------------------
# The dense engine's streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["default", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_streams_equal_jax(case, kernel_path, monkeypatch):
    ref = jax_streams(case, kernel_path)
    eng = port_engine(case, kernel_path)
    calls = h.counted_ops(monkeypatch)
    ours = port_streams(eng)
    assert ours == ref
    assert all(len(o) == MAX_NEW for o in ours)
    assert calls == {}                       # no registry op on either path
    assert eng.trace_counts == {"decode": 0, "chunk": 0}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_cache_and_decode_logits_match_jax(case):
    """A bucketed prefill (a 64-wide bucket, 40 and 64 real tokens: both
    past the window of 32) into caches 8 rows longer, every assembled
    cache leaf, then three decode steps over them."""
    jp, npp = weights(case)
    cfg, tcfg = configs(case)
    jm = JModel(cfg)
    model = Model(tcfg, device="cpu")
    tp = bridge.prepare_for_serving(bridge.params_from_jax(npp), tcfg)
    V = cfg.vocab_size
    toks = np.zeros((2, 64), np.int32)
    toks[0, :40] = np.arange(40) * 7 % V
    toks[1] = np.arange(64) * 5 % V
    lengths = np.asarray([40, 64], np.int32)
    jpre = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t},
                                              extra_slots=8, lengths=n))
    ref, jcache = jpre(jp, jnp.asarray(toks), jnp.asarray(lengths))
    ours, cache = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                extra_slots=8, lengths=lengths)
    assert _rel(ours.numpy(), ref) <= 1e-5
    want = h.flat(jax.tree.map(np.asarray, jcache))
    got = h.flat(bridge.to_numpy(cache))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        if path[-1] == "pos":
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
        else:
            assert _rel(got[path], leaf) <= 1e-5, path
    step = jax.jit(jm.decode_step)
    tok = np.asarray([[3], [9]], np.int32)
    pos = lengths[:, None].copy()
    for _ in range(3):
        ref, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        ours, cache = model.decode_step(tp, cache, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        ref = np.asarray(ref)
        assert _rel(ours.numpy(), ref) <= 1e-5
        tok = ref.argmax(-1).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_raises_the_reference_value_error(arch):
    case = "mamba2" if arch == "mamba2-2.7b" else "rglru3"
    cfg, tcfg = configs(case)
    with pytest.raises(ValueError) as want:
        JServeEngine(cfg, params=weights(case)[0], paged=True, **KW)
    with pytest.raises(ValueError) as got:
        ServeEngine(tcfg, paged=True, device="cpu", **KW)
    assert str(got.value) == str(want.value)
    assert not Model(tcfg, device="meta").supports_paged()
    assert not JModel(cfg).supports_paged()


def test_mesh_and_disaggregation_wait_for_a12():
    """Meshed serving, meshed training and the disaggregator are ported
    for these families (ROADMAP.md's A.12, done). The unmeshed
    disaggregator hands each request's recurrent state to the decode pool
    and gives the engine's streams (the JAX engine's, as
    ``test_streams_equal_jax`` holds them). In a fake world of 2 on ``meta``
    the meshed engine builds on (1, 2) with its cache cut as the blocks
    run: the SSD state by heads and the conv tail by its heads' x channels
    with B and C whole (``sharding.Tail``), the RG-LRU ``h`` and conv tail
    by channels; the meshed train step builds. Their values:
    ``test_torch_mesh_families.py``."""
    from repro_torch.launch import dryrun
    from repro_torch.parallel.context import Mesh, ParallelCtx
    from repro_torch.serve.disagg import Disaggregator
    from repro_torch.train.trainer import TrainConfig, make_train_step
    for case in ("mamba2", "rglru3"):
        _, tcfg = configs(case)
        dis = Disaggregator(tcfg, params=bridge.params_from_jax(
            weights(case)[1]), decode_slots=2, max_len=KW["max_len"],
            chunk=KW["chunk"], device="cpu")
        reqs = [Request(i, p, max_new=MAX_NEW)
                for i, p in enumerate(prompts(tcfg.vocab_size))]
        for r in reqs:
            dis.submit(r)
        dis.run()
        assert [list(map(int, r.out)) for r in reqs] == port_streams(
            port_engine(case))
        model = Model(tcfg, device="meta")
        with dryrun.fake_world(2):
            ctx = ParallelCtx(mesh=Mesh.create((1, 2)))
            eng = ServeEngine(tcfg, params=model.param_structs(), ctx=ctx,
                              device="meta")
            assert make_train_step(model, TrainConfig(), ctx=ctx)
        whole = model.init_cache(1, 8, device="meta")
        for path, t in h.flat(eng.cache).items():
            want = list(h.flat(whole)[path].shape)
            want[1] = eng.slots
            if path[-1] in ("state", "h"):
                want[-3 if path[-1] == "state" else -1] //= 2
            if path[-1] == "conv" and tcfg.ssm:
                want[-1] = (want[-1] - 2 * tcfg.ssm.d_state) // 2 \
                    + 2 * tcfg.ssm.d_state
            elif path[-1] == "conv":
                want[-1] //= 2
            if path[-1] in ("state", "h", "conv"):
                assert list(t.shape) == want, (case, path, t.shape, want)


@pytest.mark.parametrize("case", ["mamba2", "rglru5"])
def test_decode_overlap_streams_equal_jax(case):
    """The dual-microbatch decode (the slots as two half-batches, each
    step's blocks applied to both halves before the next)."""
    ref = jax_streams(case, decode_overlap=True)
    assert port_streams(port_engine(case, decode_overlap=True)) == ref


@pytest.mark.parametrize("case", ["mamba2", "rglru5"])
def test_decode_keeps_every_cache_leaf(case):
    """``decode_loop`` writes the conv tails, the recurrent states and the
    windowed rings in place (a captured decode chunk replays the same
    buffers); the states stay fp32."""
    eng = port_engine(case)
    before = {p: t.data_ptr() for p, t in h.flat(eng.cache).items()}
    port_streams(eng)
    assert {p: t.data_ptr() for p, t in h.flat(eng.cache).items()} == before
    states = [v for k, v in h.flat(eng.cache).items()
              if k[-1] in ("state", "h")]
    assert states and all(t.dtype == torch.float32 for t in states)


# ---------------------------------------------------------------------------
# Training: the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_leaf_match_jax(case):
    jp, npp = weights(case)
    cfg, tcfg = configs(case)
    batch = SyntheticCorpus(cfg.vocab_size, 32, 4, seed=3).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(JModel(cfg).loss,
                                                has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = bridge.params_from_jax(npp)
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
    bad = {}
    for (path, _), g in zip(items, grads):
        err = _rel(g, want[path])
        if err > 1e-4:
            bad[path] = err
    assert not bad, bad


# ---------------------------------------------------------------------------
# FP8 on the recurrent blocks
# ---------------------------------------------------------------------------


def test_fp8_preparation_reaches_the_recurrent_linears():
    """At an LRU width and an SSD inner width of 256, every 2-D weight
    that feeds ``linear`` with an input width of 256 or more gains its
    ``Fp8Weight``; ``wa``, ``wi`` and ``conv_w`` stay plain tensors, and
    the prepared trees' logits equal the raw trees' within 1e-5."""
    for arch, over in (("mamba2-2.7b", dict(d_model=256)),
                       ("recurrentgemma-9b", dict(d_model=256))):
        tcfg = dataclasses.replace(tsmoke(tget(arch)), fp8=True, **over)
        model = Model(tcfg, device="cpu")
        raw = model.init(seed=1)
        ready = bridge.prepare_for_serving(raw, tcfg)
        flat = h.flat({k: v for k, v in ready.items() if isinstance(v, dict)})
        quantized = sorted("/".join(p[1:]) for p, v in flat.items()
                           if isinstance(v, fp8.Fp8Weight))
        for p, v in flat.items():
            if p[-1] in ("wa", "wi", "conv_w", "conv_b", "lam", "a_log"):
                assert type(v) is torch.Tensor, p
        if arch == "mamba2-2.7b":
            assert quantized == ["w_in", "w_out"]
        else:
            assert {"r0/w_x", "r0/w_y", "r0/w_out", "r1/w_x", "a2/attn/wq",
                    "a2/mlp/w_down", "r0/mlp/w_gate"} <= set(quantized)
        toks = {"tokens": torch.arange(64)[None] * 5 % tcfg.vocab_size}
        a, _ = model.prefill(ready, toks)
        b, _ = model.prefill(raw, toks)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
