"""PyTorch port: every family under a mesh — the recurrent families
(mamba2-2.7b, recurrentgemma-9b: the SSD and RG-LRU blocks
tensor-parallel by heads or channels), the dense/MoE pairs
(llama4-maverick) and the families with a memory (seamless-m4t-large-v2,
llama-3.2-vision-90b) — served, disaggregated and trained on gloo ranks on
the CPU, against the JAX reference at smoke width (fp32).

One spawn of 8 ranks (rank body ``tests/_torch_mesh_families.py``, no
JAX) on weights bridged from the JAX inits; the JAX side runs here, single
device, while the ranks work:

* serving on (2, 4): every family's greedy streams and stats on the dense
  engine equal the JAX single-device engine's; llama4 on ``ep_flat`` and
  ``ep_dedup`` and with ``decode_overlap=True``; llama4 and seamless on
  paged bf16 (against the dense streams) and paged fp8 (against JAX's
  paged fp8 engine); mamba2 and recurrentgemma on (2, 2, 2), the slots
  over ("pod", "data"). Every rank's mirrors and streams are one CRC.
* the blocks alone on (1, 4): ``ssd_block_apply`` and
  ``recurrent_block_apply`` on layer 0 of the model's weights against the
  JAX blocks, with and without the sequence cut: the prefill output and
  cache entries (the cut state and conv tail made whole, the Mamba-2 tail
  through its ``sharding.Tail``) and one decode step within 1e-6 of the
  largest magnitude, every gradient leaf within 1e-4 of its largest.
* training on (2, 2), ranks 0-3: 3-step ``Trainer`` trajectories of
  mamba2, recurrentgemma and llama4 (``ep_flat``), with and without
  ``seq_axis="model"``, against JAX's single-device ``Trainer`` within
  ``tests/test_torch_train_mesh.py``'s bounds (the reference's, and the
  port's own ``OWN_BOUND``); one meshed step of seamless on (2, 2) and of
  vision with 2 KV heads on (1, 4) (its query heads cut, its KV heads
  whole on each rank), with their extras and with and without the
  sequence cut: the loss within 1e-5 and every gradient leaf within 1e-4
  of ``jax.value_and_grad``.
* disaggregation: the unmeshed handoff of mamba2 and recurrentgemma, and
  the cross-mesh handoff (prefill on (2, 4), decode on (1, 4)) of mamba2,
  llama4 and seamless, give the JAX engine's streams.
* ``chip_smoke.py`` phase (l)'s planted faults at smoke width on (1, 4):
  the sound mesh within ``SMOKE_BOUND`` of the witness (one device), each
  fault outside it.

The module takes about 70 s alone.
"""
import dataclasses
import multiprocessing
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_families as body
from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainConfig as JTrainConfig
from repro_torch import bridge
from repro_torch.train import optimizer as optim

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

WORLD = 8
TRAINED = ("mamba2", "rglru", "llama4")
DRAWN = ("seamless", "vision", "vision_kv2")
# tests/test_torch_train_mesh.py's bounds: the reference's (dense, MoE) and
# the port's own meshed-vs-single-device bound
REF_BOUND = {"mamba2": 2e-3, "rglru": 2e-3, "llama4": 5e-3}
OWN_BOUND = 2e-5
# phase (l)'s gate at smoke width in fp32: the sound mesh's logits off the
# witness's by at most this, over max|logit|
SMOKE_BOUND = 1e-5


def _jconfigs():
    llama4 = smoke_config(get_config("llama4-maverick-400b-a17b"))
    llama4 = dataclasses.replace(llama4, moe=dataclasses.replace(
        llama4.moe, capacity_factor=8.0))
    vision = smoke_config(get_config("llama-3.2-vision-90b"))
    return {"mamba2": smoke_config(get_config("mamba2-2.7b")),
            "rglru": smoke_config(get_config("recurrentgemma-9b")),
            "llama4": llama4,
            "seamless": smoke_config(get_config("seamless-m4t-large-v2")),
            "vision": vision,
            "vision_kv2": dataclasses.replace(vision, num_kv_heads=2)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_serve(cfg, params, **kw):
    eng = JServeEngine(cfg, params=params, slots=body.SLOTS,
                       max_len=body.MAX_LEN, seed=0, chunk=body.CHUNK, **kw)
    reqs = [JRequest(i, p, max_new=body.MAX_NEW)
            for i, p in enumerate(body.prompts_for(cfg.vocab_size))]
    for i, r in enumerate(reqs):
        eng.submit(r, body.extras_for(cfg, i))
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return dict(streams=[list(map(int, r.out)) for r in reqs],
                stats=[eng.stats[k] for k in body.STATS])


def _jax_block(model, cfg, params):
    """The JAX block on layer 0: the prefill output and cache entries,
    every gradient of ``sum(y * w)``, one decode step and its cache."""
    apply, seg, names = (
        (jssm.ssd_block_apply, ("blocks",), ("conv", "state"))
        if model == "mamba2" else
        (jrglru.recurrent_block_apply, ("pat", "r0"), ("conv", "h")))
    p = params
    for k in seg:
        p = p[k]
    p = jax.tree.map(lambda a: a[0], p)
    x, x1, w = (jnp.asarray(a) for a in body.block_inputs(cfg))

    def f(p):
        y, ent, _ = apply(p, x, cfg, {"collect_cache": True})
        return jnp.sum(y * w), (y, ent)

    (_, (y, ent)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(p)
    cache = dict(zip(names, ent))
    y1, new, _ = jax.jit(lambda p, c: apply(p, x1, cfg, {}, c))(p, cache)
    return dict(y=np.asarray(y), grads=bridge.params_from_jax(_np(g)),
                prefill_cache={k: np.asarray(v) for k, v in cache.items()},
                y1=np.asarray(y1),
                decode_cache={k: np.asarray(new[k]) for k in names})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_families")
    jcfgs = _jconfigs()
    tc = JTrainConfig(**body.TC)
    jts, npp, inputs = {}, {}, {}
    for m in TRAINED:
        jt = JTrainer(jcfgs[m], tc, global_batch=body.BATCH,
                      seq_len=body.SEQ)
        jts[m], npp[m] = jt, _np(jt.params)
        params, opt = bridge.train_state_from_jax(npp[m], _np(jt.opt_state))
        inputs["state:" + m] = dict(params=params, step=opt.step,
                                    master=opt.master, m=opt.m, v=opt.v)
    for m in DRAWN:
        npp[m] = _np(jax.jit(JModel(jcfgs[m]).init)(jax.random.PRNGKey(0)))
        if jcfgs[m].family == "vlm":
            # the gates init at zero: tanh(0) would hide the cross layers
            rng = np.random.default_rng(11)
            cross = npp[m]["pat"]["cross"]
            for g in ("gate_attn", "gate_mlp"):
                cross[g] = rng.normal(size=cross[g].shape).astype(
                    cross[g].dtype)
    for m in jcfgs:
        inputs["weights:" + m] = bridge.params_from_jax(npp[m])
    torch.save(inputs, d / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=body.run_rank,
                         args=(r, WORLD, str(d / "store"), str(d)))
             for r in range(WORLD)]
    for p in ranks:
        p.start()
    ref = {}
    jp = {m: jax.tree.map(jnp.asarray, t) for m, t in npp.items()}
    with kernels.use_backend("ref"):
        for m in ("mamba2", "rglru", "llama4", "seamless", "vision"):
            ref["serve:" + m] = _jax_serve(jcfgs[m], jp[m])
        for m in ("llama4", "seamless"):
            ref["serve_fp8:" + m] = _jax_serve(
                jcfgs[m], jp[m], paged=True, page_size=8,
                page_storage="fp8")
    for m in ("mamba2", "rglru"):
        ref["block:" + m] = _jax_block(m, jcfgs[m], jp[m])
    for m in ("seamless", "vision_kv2"):
        batch = {k: jnp.asarray(v)
                 for k, v in body.train_batch(jcfgs[m]).items()}
        (jl, _), jg = jax.jit(jax.value_and_grad(
            JModel(jcfgs[m]).loss, has_aux=True))(jp[m], batch)
        ref["grads:" + m] = dict(loss=float(jl),
                                 grads=bridge.params_from_jax(_np(jg)))
    for m, jt in jts.items():
        out = jt.run(body.STEPS)
        ref["traj:" + m] = dict(
            loss=[h["loss"] for h in out["history"]],
            grad_norm=[h["grad_norm"] for h in out["history"]],
            params=bridge.params_from_jax(_np(jt.params)))
    for p in ranks:
        p.join(timeout=600)
    codes = [p.exitcode for p in ranks]
    for p in ranks:
        if p.is_alive():
            p.kill()
    assert codes == [0] * WORLD, codes
    ours = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return ref, ours


def _streams(arr):
    return [[int(t) for t in row if t >= 0] for row in arr]


# scenario -> (the JAX reference it equals, whether its stats are the
# reference's: the same engine mode)
SERVED = {"mamba2": ("serve:mamba2", True), "rglru": ("serve:rglru", True),
          "llama4_flat": ("serve:llama4", True),
          "llama4_dedup": ("serve:llama4", True),
          "llama4_overlap": ("serve:llama4", False),
          "llama4_paged": ("serve:llama4", False),
          "llama4_paged_fp8": ("serve_fp8:llama4", True),
          "seamless": ("serve:seamless", True),
          "seamless_paged": ("serve:seamless", False),
          "seamless_paged_fp8": ("serve_fp8:seamless", True),
          "vision": ("serve:vision", True),
          "pod_mamba2": ("serve:mamba2", True),
          "pod_rglru": ("serve:rglru", True)}


@pytest.mark.parametrize("name", list(SERVED))
def test_meshed_streams_equal_the_jax_engine(run, name):
    ref, ours = run
    key, same_mode = SERVED[name]
    want = ref[key]
    got = [o["serve:" + name] for o in ours]
    assert _streams(got[0]["streams"]) == want["streams"], name
    assert all(len(s) == body.MAX_NEW for s in want["streams"])
    assert len({g["mirrors"] for g in got}) == 1, name
    if same_mode:
        assert list(got[0]["stats"]) == want["stats"], name


@pytest.mark.parametrize("model", list(body.DISAGG))
def test_cross_mesh_handoff_equals_the_jax_engine(run, model):
    ref, ours = run
    want = ref["serve:" + model]["streams"]
    for r in range(4):                        # the decode mesh's ranks
        assert _streams(ours[r]["disagg:" + model]) == want, (model, r)
    for r in range(4, WORLD):                 # prefill only
        assert _streams(ours[r]["disagg:" + model]) == [[]] * len(want)


@pytest.mark.parametrize("model", ["mamba2", "rglru"])
def test_unmeshed_handoff_of_recurrent_state_equals_the_jax_engine(run,
                                                                   model):
    ref, ours = run
    assert (_streams(ours[0]["disagg_one:" + model])
            == ref["serve:" + model]["streams"])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", ["mamba2", "mamba2_sp", "rglru",
                                  "rglru_sp"])
def test_block_alone_matches_jax(run, name):
    ref, ours = run
    want = ref["block:" + name.split("_")[0]]
    for r in range(4):
        got = ours[r]["blocks"][name]
        assert _rel(got["y"], want["y"]) <= 1e-6, (name, r)
        assert _rel(got["y1"], want["y1"]) <= 1e-6, (name, r)
        for part in ("prefill_cache", "decode_cache"):
            for k, v in want[part].items():
                assert _rel(got[part][k], v) <= 1e-6, (name, r, part, k)
        items = optim.tree_items(want["grads"])
        assert [p for p, _ in optim.tree_items(got["grads"])] == \
            [p for p, _ in items]
        for (p, g), (_, w) in zip(optim.tree_items(got["grads"]), items):
            assert _rel(g, w) <= 1e-4, (name, r, p)


def _max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for (_, x), (_, y) in zip(optim.tree_items(a),
                                         optim.tree_items(b)))


@pytest.mark.parametrize("traj", list(body.TRAJ))
def test_trajectory_matches_jax_single_device(run, traj):
    ref, ours = run
    model = body.TRAJ[traj][0]
    want = ref["traj:" + model]
    for r in range(4):
        got = ours[r]["traj:" + traj]
        dl = max(abs(a - b) for a, b in zip(got["loss"], want["loss"]))
        dp = _max_diff(got["params"], want["params"])
        dg = max(abs(a - b) / b for a, b in zip(got["grad_norm"],
                                                want["grad_norm"]))
        why = (traj, r, dl, dp, dg)
        assert len(got["loss"]) == body.STEPS
        assert dl < REF_BOUND[model] and dp < REF_BOUND[model], why
        assert dl < OWN_BOUND and dp < OWN_BOUND and dg < OWN_BOUND, why


@pytest.mark.parametrize("name", list(body.GRADS))
def test_meshed_step_with_extras_matches_jax(run, name):
    ref, ours = run
    want = ref["grads:" + body.GRADS[name][0]]
    for r in range(4):
        got = ours[r]["grads:" + name]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for (p, g), (_, w) in zip(optim.tree_items(got["grads"]),
                                  optim.tree_items(want["grads"])):
            assert _rel(g, w) <= 1e-4, (name, r, p)


@pytest.mark.parametrize("name,fault", [
    (n, f) for n, fs in body.FAULTS.items() for f in ("sound",) + fs])
def test_planted_faults_fail_the_bound(run, name, fault):
    """Phase (l)'s readings at smoke width (``chip_smoke.family_run``):
    the sound mesh within ``SMOKE_BOUND`` of the one-device witness on
    each prompt's prefill and one decode step, with the witness's greedy
    streams; each planted fault outside it on the decode step."""
    _, ours = run
    got = ours[0]["faults"][name]
    reading = got["readings"][fault]
    errs = [chip_smoke.logit_agreement(reading[part],
                                       got["witness"][part])["err"]
            for part in reading]
    if fault == "sound":
        assert max(errs) <= SMOKE_BOUND, errs
        assert got["outs"] == got["witness_outs"]
    else:
        assert max(errs) > SMOKE_BOUND, errs
