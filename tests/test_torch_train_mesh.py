"""PyTorch port: the meshed train step (``train/trainer.make_train_step``
and ``Trainer`` with ``ctx=ParallelCtx(mesh=...)``) against the JAX
reference, on 4 spawned gloo ranks on the CPU.

One spawn per module (rank body ``tests/_torch_train_mesh.py``, no JAX,
one torch thread a rank) runs every scenario; the JAX scenarios run once
per module fixture, single-device and in process, while the ranks work.
Weights are the JAX ``Model.init`` trees of the smoke configs (fp32),
copied through the bridge, the optimizer state with them. Mirrors
``tests/test_train_distributed.py`` and the pipeline and schedule cases
of ``tests/test_distributed.py``:

* ``Model.loss_dual`` under the (2, 2) mesh, each data rank halving its
  own rows of the uneven-pad batch, against JAX's ``Model.loss`` on the
  joined batch: 1e-5 (qwen3-14b smoke; DeepSeek-V3 smoke on ``ep_flat``).
* 3-step ``Trainer`` trajectories on the meshes against JAX's
  single-device ``Trainer`` from one state: qwen3-14b smoke at (2, 2)
  (dense; the reference's bound 2e-3), DeepSeek-V3 smoke (``fp8=False``,
  capacity 8.0) with ``ep_flat`` at (2, 2) and ``ep_dedup`` at (1, 4)
  (5e-3); the loss of each step and every parameter after. The port's own
  bound, the tightest that holds here, is ``OWN_BOUND``: the meshed
  step reorders fp32 sums (the row-parallel partials, the data ranks'
  gradients, the valid-token counts), nothing more.
* The same with sequence parallelism (``seq_axis="model"``: the residual
  stream cut along the sequence over the model axis between blocks):
  qwen3-14b smoke at (1, 4) and (2, 2), DeepSeek-V3 smoke on ``ep_flat``
  at (2, 2), within ``OWN_BOUND`` and the reference's bounds.
* The same, with and without the sequence cut, for smoke qwen3-14b
  with 6 query and 2 KV heads at (1, 4): the heads do not split over
  the model axis, so the attention runs replicated on every rank
  (``sharding.whole_heads``), its weights' gradients whole on each.
  Every trajectory's global gradient norm is held at ``OWN_BOUND``
  (relative) too: Adam's update does not see a gradient's scale.
* One train step of the dry run's kind (``Model.loss``, ``remat="full"``,
  the sequence cut) on qwen3-14b smoke and DeepSeek-V3 smoke (``ep_flat``)
  at (2, 2): rank 0's ``collectives.record()`` equals, kind by kind in
  bytes and counts, the dry run's record of the same step traced here on
  meta in a fake world of 4 (``launch/dryrun.py``).
* The FP8 wire trains: finite, within 5% of the fp32 wire (the
  reference's ``test_fp8_wire_trains``); its gradient through the codec
  equals JAX's (the codes carry none; only each tile's scale, at the
  tile's amax element).
* Checkpoint on (2, 2), restore onto (1, 2): every leaf bit for bit its
  slice of the saved array; ``FailureInjector({3: "node"})`` re-meshes a
  (2, 2) run onto (1, 2) with one restart, ranks 2-3 gone.
* Two data axes, the batch and ZeRO-3 over the pair ``("pod", "data")``:
  qwen3-14b smoke at (2, 2, 1) and (2, 1, 2), DeepSeek-V3 smoke on
  ``ep_flat`` at (2, 1, 2), against JAX's single device within
  ``OWN_BOUND`` and the reference's bounds; at (2, 1, 2) the pair is a
  line of 2 and TP runs over 2, the (2, 2) run's arithmetic, so every
  loss, grad norm and parameter equals the (2, 2) run's bit for bit.
  Checkpoint on (2, 2, 1), restore onto (1, 2, 1) bit for bit; a node
  failure from (2, 2, 1) ends on (1, 2, 1) ("pod" halved first); the
  straggler monitor has one replica per position of the pair; the dry
  run's record of a (2, 1, 2) step equals the live step's; the train
  placements equal the reference's multi-pod ``train_state_shardings``.
* Straggler: one EWMA entry per replica, ``slow:1`` flags replica 1 only,
  a clean run none. SDC: the alarm at step 3, one checksum per rank, all
  equal.
* ``sharded_global_norm`` against the unsharded norm: 1e-6 relative;
  each differentiable collective's backward equal to its transpose
  worked by hand.
* A MoE layer's forward + backward all-to-all bytes on ``bench_config``
  at (1, 4) from ``collectives.record()``: ``ep_dedup`` < ``ep_flat``;
  the dual step's all-to-alls a MoE layer exactly twice the single
  step's, forward and backward.
* ``pipeline_forward`` against the sequential stages: forward 1e-5,
  gradients 1e-4 of the largest; ``onef1b_bubble`` and
  ``dualpipe_bubble`` equal to JAX's; the train placements the
  reference's ``train_state_shardings``.
* ``chip_smoke.py`` phase (i.1)'s gate (``train_gate``,
  ``MESH_TRAIN_LIMITS``) at smoke width: the sound (2, 2) run passes it
  against the port's single-device run, each planted fault fails it.

The module takes about 60 s.
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

import _torch_train_mesh as body
from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.parallel import ep as jep
from repro.parallel import pipeline as jpipe
from repro.parallel import sharding as jsh
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainConfig as JTrainConfig
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models.api import Model
from repro_torch.parallel import ep, pipeline
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.context import Mesh
from repro_torch.train import optimizer as optim

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

WORLD = 4
# trajectory -> (JAX scenario, the reference's bound)
BOUNDS = {"qwen_2x2": ("qwen", 2e-3), "moe_flat_2x2": ("moe", 5e-3),
          "moe_dedup_1x4": ("moe", 5e-3), "qwen_sp_1x4": ("qwen", 2e-3),
          "qwen_sp_2x2": ("qwen", 2e-3), "moe_sp_flat_2x2": ("moe", 5e-3),
          "qwen_heads_whole_1x4": ("qwen_heads6", 2e-3),
          "qwen_heads_whole_sp_1x4": ("qwen_heads6", 2e-3),
          "qwen_2x2x1": ("qwen", 2e-3), "qwen_2x1x2": ("qwen", 2e-3),
          "moe_flat_2x1x2": ("moe", 5e-3)}
# a pod trajectory and the (data, model) one it equals bit for bit
SAME_AS = {"qwen_2x1x2": "qwen_2x2", "moe_flat_2x1x2": "moe_flat_2x2"}
# the port's own meshed-vs-single-device bound (loss and parameters)
OWN_BOUND = 2e-5
# trajectories whose parameters after 3 steps the port holds tighter than
# the reference's bound but not at OWN_BOUND: qwen_heads_whole_1x4's
# embedding moves 2.27e-5 from JAX's (the port's own single device: 8e-6),
# while its loss, its grad norms and (test_whole_heads_gradients_match_jax)
# every gradient leaf agree within 1.6e-6 relative. AdamW's first updates
# are ~lr x sign(g), so an element whose gradient is near zero turns a
# reordered fp32 sum into a visible step.
OWN_PARAM_BOUND = {"qwen_heads_whole_1x4": 3e-5}


def _jconfigs():
    moe = smoke_config(get_config("deepseek-v3-671b"))
    moe = dataclasses.replace(moe, fp8=False, moe=dataclasses.replace(
        moe.moe, capacity_factor=8.0))
    qwen = smoke_config(get_config("qwen3-14b"))
    return {"qwen": qwen, "moe": moe,
            "qwen_heads6": dataclasses.replace(qwen, **body.HEADS6)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    jcfgs = _jconfigs()
    tc = JTrainConfig(**body.TC)
    jts, inputs = {}, {}
    for name, cfg in jcfgs.items():
        jt = JTrainer(cfg, tc, global_batch=body.BATCH, seq_len=body.SEQ)
        params, opt = bridge.train_state_from_jax(_np(jt.params),
                                                  _np(jt.opt_state))
        inputs["state:" + name] = dict(params=params, step=opt.step,
                                       master=opt.master, m=opt.m, v=opt.v)
        jts[name] = jt
    torch.save(inputs, d / "inputs.pt")
    os.makedirs(d / "shared")
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=body.run_rank,
                         args=(r, WORLD, str(d / "store"), str(d)))
             for r in range(WORLD)]
    for p in ranks:
        p.start()
    ref = {}
    for name, jt in jts.items():
        cfg = jcfgs[name]
        m = JModel(cfg)
        batch = {k: jnp.asarray(v)
                 for k, v in body.uneven_batch(cfg.vocab_size).items()}
        ref["loss:" + name] = float(m.loss(jt.params, batch)[0])
        if name == "qwen_heads6":
            b = {k: jnp.asarray(v) for k, v in
                 body.recorded_batch(cfg.vocab_size).items()}
            (jl, _), jg = jax.value_and_grad(m.loss, has_aux=True)(
                jt.params, b)
            ref["grads:" + name] = dict(
                loss=float(jl), grads=bridge.params_from_jax(_np(jg)))
        out = jt.run(body.STEPS)
        ref["traj:" + name] = dict(
            loss=[h["loss"] for h in out["history"]],
            grad_norm=[h["grad_norm"] for h in out["history"]],
            params=bridge.params_from_jax(_np(jt.params)))
    for p in ranks:
        p.join(timeout=400)
    codes = [p.exitcode for p in ranks]
    for p in ranks:
        if p.is_alive():
            p.kill()
    assert codes == [0] * WORLD, codes
    ours = [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]
    return ref, ours


def _max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for (_, x), (_, y) in zip(optim.tree_items(a),
                                         optim.tree_items(b)))


def _worst_leaf(a, b):
    return max((float((x.float() - y.float()).abs().max()), p)
               for (p, x), (_, y) in zip(optim.tree_items(a),
                                         optim.tree_items(b)))


@pytest.mark.parametrize("name", ["qwen", "moe"])
def test_dual_loss_with_uneven_pads_under_a_mesh(run, name):
    ref, ours = run
    for r in range(WORLD):
        got = ours[r]["dual_pads"][name]
        assert abs(got - ref["loss:" + name]) < 1e-5, (r, got, ref)


@pytest.mark.parametrize("traj", list(BOUNDS))
def test_trajectory_matches_jax_single_device(run, traj):
    ref, ours = run
    model, bound = BOUNDS[traj]
    want = ref["traj:" + model]
    for r in range(WORLD):
        got = ours[r]["traj:" + traj]
        dl = max(abs(a - b) for a, b in zip(got["loss"], want["loss"]))
        dp = _max_diff(got["params"], want["params"])
        # the global gradient norm of each step (Adam's update is blind
        # to a gradient's scale): relative
        dg = max(abs(a - b) / b for a, b in zip(got["grad_norm"],
                                                want["grad_norm"]))
        why = (traj, r, dl, dp, dg, _worst_leaf(got["params"],
                                                 want["params"]))
        assert len(got["loss"]) == body.STEPS
        assert dl < bound and dp < bound, why
        assert dl < OWN_BOUND, why
        assert dp < OWN_PARAM_BOUND.get(traj, OWN_BOUND), why
        assert dg < OWN_BOUND, why


@pytest.mark.parametrize("traj", list(SAME_AS))
def test_pod_trajectory_equals_the_two_axis_run_bitwise(run, traj):
    """At (2, 1, 2) the pair ("pod", "data") is a line of 2, as "data" is
    at (2, 2): the same ZeRO-3 gathers and reduce-scatters, batch rows,
    TP and EP, and sums of two addends. Every loss, grad norm, parameter
    and step-1 update equals the (2, 2) run's bit for bit."""
    _, ours = run
    for r in range(WORLD):
        got, want = ours[r]["traj:" + traj], ours[r]["traj:" + SAME_AS[traj]]
        assert got["loss"] == want["loss"], (r, got["loss"], want["loss"])
        assert got["grad_norm"] == want["grad_norm"], r
        for key in ("params", "update"):
            for (p, a), (_, b) in zip(optim.tree_items(got[key]),
                                      optim.tree_items(want[key])):
                assert torch.equal(a, b), (r, key, p)


@pytest.mark.parametrize("name", ["mesh", "mesh_sp"])
def test_whole_heads_gradients_match_jax(run, name):
    """Smoke qwen3-14b with 6 query and 2 KV heads on (1, 4): the
    attention runs replicated over the model axis, with (``mesh_sp``) and
    without (``mesh``) the sequence cut. ``Model.loss`` and every logical
    gradient leaf (the replicated wq, wk, wv, wo and norms whole on each
    rank) against ``jax.value_and_grad`` of the reference's single-device
    loss: the loss within 1e-5 relative, each leaf within 1e-4 of its
    largest reference magnitude (``test_torch_train.py``'s bounds); and
    against the port's own single device within ``OWN_BOUND`` of each
    leaf's largest magnitude."""
    ref, ours = run
    want = ref["grads:qwen_heads6"]
    for r in range(WORLD):
        got, one = ours[r]["whole_heads"][name], ours[r]["whole_heads"]["one"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for (p, g), (_, w), (_, o) in zip(optim.tree_items(got["grads"]),
                                          optim.tree_items(want["grads"]),
                                          optim.tree_items(one["grads"])):
            scale = float(w.abs().max())
            assert g.shape == w.shape, (p, g.shape, w.shape)
            err = float((g - w).abs().max()) / scale
            own = float((g - o).abs().max()) / scale
            assert err < 1e-4 and own < OWN_BOUND, (name, r, p, err, own)


@pytest.mark.parametrize("name", list(body.RECORDED))
def test_dry_run_records_the_live_steps_collectives(run, name,
                                                     monkeypatch):
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    _, ours = run
    model, shape, kw = body.RECORDED[name]
    cfg = body.configs()[model]
    monkeypatch.setattr(dryrun, "get_config", lambda a: cfg)
    monkeypatch.setattr(dryrun, "SHAPES", {"t": ShapeCfg(
        "t", body.SEQ, body.BATCH, "train")})
    axes = ("data", "model") if len(shape) == 2 else body.POD_AXES
    monkeypatch.setattr(mesh_mod, "production_shape",
                        lambda multi_pod=False: (shape, axes))
    rec = dryrun.run_cell(cfg.name, "t", multi_pod=len(shape) == 3,
                          out_dir="",
                          moe_impl=kw.get("moe_impl", "ep_dedup"),
                          wire=kw.get("wire", "fp8"), remat=kw["remat"])
    assert rec["status"] == "ok", rec.get("error")
    live = ours[0]["recorded"][name]
    assert live["total"] > 0
    assert rec["collectives"] == live


def test_fp8_wire_trains(run):
    _, ours = run
    for r in range(WORLD):
        fp8 = ours[r]["traj:moe_dedup_1x4_fp8"]["loss"]
        fp32 = ours[r]["traj:moe_dedup_1x4"]["loss"][:len(fp8)]
        assert all(np.isfinite(fp8))
        for a, b in zip(fp32, fp8):
            assert abs(a - b) / abs(a) < 0.05, (a, b)


def test_fp8_wire_gradient_equals_jax():
    """The reference's FP8 wire bitcasts the E4M3 codes to bytes, so the
    codes carry no cotangent and the gradient reaches x only through each
    1x128 tile's fp32 scale, at the tile's amax element; the port detaches
    the codes and keeps the scale's gradient. ``sum(decode(encode(x))^2)``
    on (4, 256): 8 nonzero entries, equal to JAX's."""
    x = np.random.default_rng(3).standard_normal((4, 256)).astype(
        np.float32)

    def jloss(v):
        q, s = jep._wire_encode(v, "fp8")
        return jnp.sum(jep._wire_decode(q, s, jnp.float32, "fp8") ** 2)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    q, s = ep._wire_encode(xt, "fp8")
    tg, = torch.autograd.grad((ep._wire_decode(q, s, torch.float32,
                                                "fp8") ** 2).sum(), [xt])
    assert np.count_nonzero(jg) == np.count_nonzero(tg.numpy()) == 8
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-6, atol=0)


def test_checkpoint_restores_onto_the_survivor_mesh_bitwise(run):
    _, ours = run
    for r in (0, 1):
        res = ours[r]["restore"]
        assert res["step"] == 2 and res["leaves"] > 0
        assert res["bad"] == [], res["bad"]
        assert res["mesh"] == {"axes": ["data", "model"], "shape": [2, 2]}
    assert all("restore" not in ours[r] for r in (2, 3))


def test_pod_checkpoint_and_node_failure(run):
    """Checkpoint at (2, 2, 1), its ZeRO-3 cut over the pair, restored onto
    (1, 2, 1) over ranks 0-1: every leaf bit for bit its slice of the
    saved array. ``FailureInjector({3: "node"})`` at (2, 2, 1) halves
    "pod": ranks 0-1 end on (1, 2, 1) after one restart, ranks 2-3 leave.
    The straggler monitor watches the pair's 4 positions and flags
    position 1 alone."""
    _, ours = run
    for r in (0, 1):
        res = ours[r]["pod_restore"]
        assert res["step"] == 2 and res["leaves"] > 0 and res["pair_cut"] > 0
        assert res["bad"] == [], res["bad"]
        assert res["mesh"] == {"axes": list(body.POD_AXES),
                               "shape": [2, 2, 1]}
        assert ours[r]["pod_node"] == dict(final_step=6, restarts=1,
                                           mesh_shape=(1, 2, 1), left=False)
    for r in (2, 3):
        assert "pod_restore" not in ours[r]
        node = ours[r]["pod_node"]
        assert node["left"] and node["restarts"] == 1
        assert node["mesh_shape"] == (1, 2, 1) and node["final_step"] < 6
    for r in range(WORLD):
        slow = ours[r]["pod_slow"]
        assert slow["ewma"] == 4 and slow["events"], slow
        assert all(ev == [1] for ev in slow["events"]), slow


def test_node_failure_remeshes_onto_the_survivors(run):
    _, ours = run
    for r in (0, 1):
        assert ours[r]["node"] == dict(final_step=6, restarts=1,
                                       mesh_shape=(1, 2), left=False)
    for r in (2, 3):
        node = ours[r]["node"]
        assert node["left"] and node["restarts"] == 1
        assert node["mesh_shape"] == (1, 2) and node["final_step"] < 6


def test_straggler_one_entry_per_replica(run):
    _, ours = run
    for r in range(WORLD):
        slow = ours[r]["slow"]
        assert slow["ewma"] == 2 and slow["events"], slow
        assert all(ev == [1] for ev in slow["events"]), slow
        assert ours[r]["clean"] == [], ours[r]["clean"]


def test_sdc_alarm_one_checksum_per_rank(run):
    _, ours = run
    for r in range(WORLD):
        assert ours[r]["sdc"] == dict(alarms=[3], checksums=WORLD,
                                      distinct=1), ours[r]["sdc"]


@pytest.mark.parametrize("model", ["qwen", "moe"])
def test_sharded_global_norm(run, model):
    _, ours = run
    for r in range(WORLD):
        got, want = ours[r]["norm"][model]
        assert abs(got - want) <= 1e-6 * want, (r, got, want)


@pytest.mark.parametrize("op", ["reduce_sum", "copy_to_group",
                                "gather_slice", "gather_rs", "scatter_sum"])
def test_collective_backward_is_its_transpose(run, op):
    _, ours = run
    for r in range(WORLD):
        assert ours[r]["grads"][op] == 0.0, (op, r, ours[r]["grads"])


def test_train_step_alltoall_bytes_dedup_below_flat(run):
    _, ours = run
    for r in range(WORLD):
        b = ours[r]["bytes"]
        flat = b["ep_flat"]["fwd"] + b["ep_flat"]["bwd"]
        dedup = b["ep_dedup"]["fwd"] + b["ep_dedup"]["bwd"]
        assert b["ep_dedup"]["bwd"] > 0 and 0 < dedup < flat, b


def test_dual_step_twice_the_alltoalls(run):
    _, ours = run
    for r in range(WORLD):
        single, dual = ours[r]["counts"]["single"], ours[r]["counts"]["dual"]
        assert single and set(single) == set(dual), (single, dual)
        assert {k.split("|")[1] for k in single} == {"fwd", "bwd"}
        assert all(dual[k] == 2 * single[k] for k in single), (single, dual)


def test_pipeline_forward_and_grad(run):
    _, ours = run
    for r in range(WORLD):
        assert ours[r]["pipe"]["fwd"] < 1e-5, ours[r]["pipe"]
        assert ours[r]["pipe"]["grad"] < 1e-4, ours[r]["pipe"]


@pytest.mark.parametrize("P,M,w", [(16, 64, 0.5), (4, 8, 0.0), (8, 3, 1.0)])
def test_schedule_models_equal_jax(P, M, w):
    for name in ("onef1b_bubble", "dualpipe_bubble"):
        ours = getattr(pipeline, name)(P, M, w=w)
        ref = getattr(jpipe, name)(P, M, w=w)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (pipeline.dualpipe_bubble(16, 64, w=0.5).bubble_frac
            < pipeline.onef1b_bubble(16, 64).bubble_frac)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (1, 4), (2, 2, 1),
                                   (2, 1, 2)])
@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b"])
def test_train_placements_equal_reference(arch, shape):
    """The placements the trainer shards its state by
    (``sharding.train_pspecs``, ``Trainer.state_pspecs``) are the
    reference's ``train_state_shardings``; on a (pod, data, model) mesh
    under its multi-pod rules (ZeRO-3 over ``("pod", "data")``), read off
    the mesh as the reference's trainer reads them."""
    from test_torch_sharding import _axes, _jmesh, _same
    pod = len(shape) == 3
    mesh = Mesh.abstract(shape, _axes(shape))
    tm = Model(tsmoke(tget(arch)), device="cpu")
    jm = JModel(smoke_config(get_config(arch)))
    pj, oj, _ = jsh.train_state_shardings(_jmesh(shape), jm.specs(),
                                          jsh.fsdp_tp_rules(pod))
    ours = sh.train_pspecs(mesh, tm.specs())
    assert _same(ours, pj) > 0
    _, ot, _ = sh.train_state_shardings(mesh, tm.specs(),
                                        sh.fsdp_tp_rules(pod))
    for field in ("master", "m", "v"):
        _same(getattr(ot, field), getattr(oj, field))


def test_fp8_training_cuts_on_128_boundaries():
    """The meshed step quantizes a rank's FP8 weight blocks itself: a
    model cut inside a 128-block raises (smoke DeepSeek-V3's d_ff 256 over
    4 columns); whole blocks pass, as at published widths at (2, 2)."""
    cfg = tsmoke(tget("deepseek-v3-671b"))
    specs = Model(cfg, device="cpu").specs()
    for shape, ok in (((2, 2), True), ((1, 4), False)):
        mesh = Mesh.abstract(shape)
        ps = sh.train_pspecs(mesh, specs)
        if ok:
            sh.check_fp8_train_cuts(specs, ps, mesh)
        else:
            with pytest.raises(ValueError, match="128-blocks"):
                sh.check_fp8_train_cuts(specs, ps, mesh)
    full = Model(tget("deepseek-v3-671b"), device="meta").specs()
    mesh = Mesh.abstract((2, 2))
    sh.check_fp8_train_cuts(full, sh.train_pspecs(mesh, full), mesh)


def test_sound_mesh_passes_the_phase_i1_gate(run):
    _, ours = run
    one = ours[0]["single:qwen"]
    for r in range(WORLD):
        got = ours[r]["traj:qwen_2x2"]
        ok, fig = chip_smoke.train_gate(one, got, _cosines(one, got))
        assert ok, fig


@pytest.mark.parametrize("fault", body.FAULTS)
def test_planted_fault_fails_the_phase_i1_gate(run, fault):
    """Each planted fault of phase (i.1), at smoke width: data rank 1's
    gradients left out of the data-axis reduction, a column-parallel
    input's backward all-reduce skipped, and pod 1's gradients left out
    of the pair's reduction at (2, 1, 2): each run fails ``train_gate``
    against the single device."""
    assert set(body.FAULTS) == set(chip_smoke.MESH_TRAIN_FAULTS)
    _, ours = run
    one = ours[0]["single:qwen"]
    for r in range(WORLD):
        got = ours[r]["fault:" + fault]
        ok, fig = chip_smoke.train_gate(one, got, _cosines(one, got))
        assert not ok, (fault, fig)


def _cosines(one, got):
    return chip_smoke.leaf_cosines(
        np, {p: t.numpy() for p, t in optim.tree_items(one["update"])},
        {p: t.numpy() for p, t in optim.tree_items(got["update"])})
