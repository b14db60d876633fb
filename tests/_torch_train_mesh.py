"""Rank body of ``tests/test_torch_train_mesh.py``: the port's meshed
train step on 4 gloo ranks on the CPU, meshes (2, 2), (1, 4), (1, 2) over
ranks 0-1, ("pipe",) of 4, and the (pod, data, model) meshes (2, 2, 1),
(2, 1, 2) and (1, 2, 1) over ranks 0-1, whose batch is cut over the pair
("pod", "data").

It imports torch, numpy and the port only, so a spawned rank starts
without JAX. Each rank reads the JAX initial states (bridged, as
``torch.save``d trees) from ``inputs.pt``, runs every scenario of
``SCENARIOS`` in turn and writes what the test compares to
``rank<r>.pt``: per trajectory the losses, grad norms and the logical
(gathered) parameters and step-1 master update; the elastic, straggler
and SDC outcomes; the norm, byte and count checks; the pipeline's errors.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

# the reference's TestShardedParity / TestElasticRemesh settings
TC = dict(peak_lr=1e-3, warmup=2, total_steps=10)
BATCH, SEQ = 8, 16
STEPS = 3
# trajectory -> (model, mesh, ctx kwargs)
TRAJ = {
    "qwen_2x2": ("qwen", (2, 2), {}),
    "moe_flat_2x2": ("moe", (2, 2), dict(moe_impl="ep_flat", wire="fp32")),
    "moe_dedup_1x4": ("moe", (1, 4), dict(moe_impl="ep_dedup",
                                          wire="fp32")),
    "moe_dedup_1x4_fp8": ("moe", (1, 4), dict(moe_impl="ep_dedup",
                                              wire="fp8")),
    # sequence parallelism over the model axis (the dry run's train cells)
    "qwen_sp_1x4": ("qwen", (1, 4), dict(seq_axis="model")),
    "qwen_sp_2x2": ("qwen", (2, 2), dict(seq_axis="model")),
    "moe_sp_flat_2x2": ("moe", (2, 2), dict(moe_impl="ep_flat", wire="fp32",
                                            seq_axis="model")),
    # 6 query and 2 KV heads do not split over 4 model columns: the
    # attention is replicated over the model axis (``sharding.whole_heads``)
    "qwen_heads_whole_1x4": ("qwen_heads6", (1, 4), {}),
    "qwen_heads_whole_sp_1x4": ("qwen_heads6", (1, 4),
                                dict(seq_axis="model")),
    # two data axes: ZeRO-3 and the batch over the pair ("pod", "data");
    # at (2, 1, 2) the same arithmetic as at (2, 2)
    "qwen_2x2x1": ("qwen", (2, 2, 1), {}),
    "qwen_2x1x2": ("qwen", (2, 1, 2), {}),
    "moe_flat_2x1x2": ("moe", (2, 1, 2), dict(moe_impl="ep_flat",
                                              wire="fp32")),
}
POD_AXES = ("pod", "data", "model")
# smoke qwen3-14b with heads that do not divide a model axis of 4
HEADS6 = dict(num_heads=6, num_kv_heads=2)
# one train step of the dry run's kind (``Model.loss``, remat, the
# sequence cut) whose collectives the test holds against the dry run's
# record of the same step traced on meta: name -> (model, mesh, ctx kwargs)
RECORDED = {
    "qwen_2x2": ("qwen", (2, 2), dict(remat="full")),
    "moe_flat_2x2": ("moe", (2, 2), dict(moe_impl="ep_flat", wire="fp32",
                                         remat="full")),
    "qwen_2x1x2": ("qwen", (2, 1, 2), dict(remat="full")),
}
# planted faults of chip_smoke.py phase (i.1), at smoke width, and the mesh
# each runs on: "pod_dropped" leaves pod 1's gradients out of the pair's
# reduction
FAULTS = ("data_rank_dropped", "copy_to_group_skipped", "pod_dropped")
FAULT_MESH = {"data_rank_dropped": (2, 2), "copy_to_group_skipped": (2, 2),
              "pod_dropped": (2, 1, 2)}
PIPE = dict(P=4, M=8, mb=2, d=16)


def configs():
    from repro_torch.configs.base import get_config, smoke_config
    moe = smoke_config(get_config("deepseek-v3-671b"))
    moe = dataclasses.replace(moe, fp8=False, moe=dataclasses.replace(
        moe.moe, capacity_factor=8.0))
    qwen = smoke_config(get_config("qwen3-14b"))
    return {"qwen": qwen, "moe": moe,
            "qwen_heads6": dataclasses.replace(qwen, **HEADS6)}


def uneven_batch(vocab: int):
    """The reference's TestDualLossEquivalence batch: (4, 16), rows 0-1
    with 3 valid labels, the last label of every row a pad."""
    g = np.random.default_rng(1)
    toks = g.integers(0, vocab, (4, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:2, 3:] = -1
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def _meshes():
    """Every mesh of the scenarios, made on every rank in one order."""
    from repro_torch.parallel.context import Mesh
    return {(2, 2): Mesh.create((2, 2)), (1, 4): Mesh.create((1, 4)),
            (1, 2): Mesh.create((1, 2), ranks=[0, 1]),
            "pipe": Mesh.create((4,), ("pipe",)),
            (2, 2, 1): Mesh.create((2, 2, 1), POD_AXES),
            (2, 1, 2): Mesh.create((2, 1, 2), POD_AXES),
            (1, 2, 1): Mesh.create((1, 2, 1), POD_AXES, ranks=[0, 1])}


def _state(inputs, model):
    from repro_torch.train import optimizer as optim
    st = inputs["state:" + model]
    opt = optim.AdamWState(st["step"], st["master"],
                           optim.tree_map(lambda t: t.bfloat16(), st["m"]),
                           optim.tree_map(lambda t: t.bfloat16(), st["v"]))
    return st["params"], opt


def logical(tree, pspecs, mesh):
    """A rank's shards gathered into the logical tree (every rank)."""
    from repro_torch.parallel.sharding import map_with_path, at_path
    from repro_torch.train.checkpoint import _logical
    return map_with_path(lambda path, t: _logical(
        t.detach(), at_path(pspecs, path), mesh).clone(), tree)


def trainer(cfg, mesh, ctx_kw, **kw):
    from repro_torch.parallel.context import ParallelCtx, data_axes
    from repro_torch.train.trainer import Trainer, TrainConfig
    ctx = None if mesh is None else ParallelCtx(
        mesh=mesh, dp_axes=data_axes(mesh.axis_names), **ctx_kw)
    tc = TrainConfig(**dict(TC, **kw.pop("tc", {})))
    return Trainer(cfg, tc, global_batch=BATCH, seq_len=SEQ, ctx=ctx,
                   device="cpu", **kw)


def trajectory(cfg, mesh, ctx_kw, state, steps=STEPS):
    """``steps`` steps from ``state``: losses, grad norms, the logical
    params after, and the logical step-1 update of the master copies
    (step 0 runs at lr 0)."""
    from repro_torch.train import optimizer as optim
    tr = trainer(cfg, mesh, ctx_kw)
    tr.load_state(*state)
    masters = []
    for _ in range(steps):
        tr.run(1)
        masters.append(optim.tree_map(lambda t: t.clone(),
                                      tr.opt_state.master))
    h = tr.history
    out = dict(loss=[x["loss"] for x in h],
               grad_norm=[x["grad_norm"] for x in h])
    params, upd = tr.params, _sub(masters[1], masters[0])
    if mesh is not None:
        ps = tr.state_pspecs()["params"]
        params, upd = logical(params, ps, mesh), logical(upd, ps, mesh)
    out["params"] = optim.tree_map(lambda t: t.detach().clone(), params)
    out["update"] = upd
    return out


def _sub(a, b):
    if isinstance(a, dict):
        return {k: _sub(a[k], b[k]) for k in a}
    return a - b


class planted:
    """Phase (i.1)'s planted faults: ``data_rank_dropped`` leaves data rank
    1's gradients out of the data-axis reduction (its reduce-scatter
    inputs and its replicated-leaf gradients enter as zeros);
    ``pod_dropped`` the same for pod 1 on a pod mesh, out of the pair's
    reduction; ``copy_to_group_skipped`` makes
    ``collectives.copy_to_group`` the plain identity, so a column-parallel
    input's backward all-reduce never runs. ``ctx_index``: this rank's
    coordinate on the axis the fault drops."""

    def __init__(self, fault, ctx_index):
        self.fault, self.d = fault, ctx_index

    def __enter__(self):
        from repro_torch.parallel import collectives as coll
        from repro_torch.train import trainer
        self.saved = (coll.reduce_scatter, coll.copy_to_group,
                      trainer._reduce_over_data)
        rs, _, red = self.saved
        drop = self.d == 1
        if self.fault in ("data_rank_dropped", "pod_dropped"):
            coll.reduce_scatter = lambda x, group, dim=0: rs(
                x * 0 if drop else x, group, dim)

            def reduce(grads, specs, group, *axes):
                if drop:
                    grads[:] = [None if g is None else g * 0 for g in grads]
                red(grads, specs, group, *axes)
            trainer._reduce_over_data = reduce
        else:
            coll.copy_to_group = lambda x, group: x
        return self

    def __exit__(self, *exc):
        from repro_torch.parallel import collectives as coll
        from repro_torch.train import trainer
        (coll.reduce_scatter, coll.copy_to_group,
         trainer._reduce_over_data) = self.saved


def dual_pads(cfgs, meshes, inputs):
    """``Model.loss_dual`` under the mesh on the uneven batch: each data
    rank halves its own rows."""
    from repro_torch.models.api import Model
    from repro_torch.parallel import context as C
    from repro_torch.parallel import sharding as sh
    out = {}
    for name, model, kw in (("qwen", "qwen", {}),
                            ("moe", "moe", dict(moe_impl="ep_flat",
                                                wire="fp32"))):
        mesh = meshes[(2, 2)]
        cfg = cfgs[model]
        m = Model(cfg, device="cpu")
        ctx = C.ParallelCtx(mesh=mesh, **kw)
        ps = sh.train_pspecs(mesh, m.specs())
        params = sh.shard_tree(inputs["state:" + model]["params"], ps, mesh)
        b = {k: torch.from_numpy(v) for k, v in
             uneven_batch(cfg.vocab_size).items()}
        d = ctx.index("data")
        b = {k: v[2 * d:2 * d + 2] for k, v in b.items()}
        ctx = dataclasses.replace(ctx, zero3=sh.Zero3(mesh, ps))
        with C.use(ctx), torch.no_grad():
            loss, _ = m.loss_dual(params, {k: v[0::2] for k, v in b.items()},
                                  {k: v[1::2] for k, v in b.items()})
        out[name] = float(loss)
    return out


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def elastic(cfgs, meshes, tmp, big=(2, 2), small=(1, 2), key=""):
    """Save on ``big``, restore onto ``small`` (ranks 0-1): every leaf
    against its slice of the saved logical array, bit for bit; then an
    injected node failure re-meshes a ``big`` run onto ``small``. On the
    pod meshes ((2, 2, 1) -> (1, 2, 1), ``key="pod_"``) the saved ZeRO-3
    cut is over the pair, the restored one over "data" alone, and "pod"
    is halved first. ``pair_cut``: the saved leaves cut over the pair."""
    from repro_torch.parallel.sharding import region_of
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import FailureInjector
    cfg = cfgs["qwen"]
    out = {}
    d1 = os.path.join(tmp, key + "ckpt")
    tr = trainer(cfg, meshes[big], {}, tc=dict(ckpt_dir=d1, ckpt_every=2))
    tr.run(2)
    if meshes[small].rank is not None:
        tr2 = trainer(cfg, meshes[small], {}, tc=dict(ckpt_dir=d1))
        tr2._init_state(restore=True)
        manifest, data = ckpt._load_verified(d1, 2)
        state = {"params": tr2.params, "opt": tr2.opt_state}
        specs = dict(ckpt._items(tr2.state_pspecs()))
        bad, n = [], 0
        for k, t in ckpt._items(state):
            want = ckpt._from_numpy(data[k], manifest["dtypes"][k])
            want = want[tuple(slice(*r) for r in region_of(
                want.shape, specs[k], meshes[small]))]
            n += 1
            if t.dtype != want.dtype or t.shape != want.shape or \
                    not torch.equal(_bytes(t), _bytes(want)):
                bad.append(k)
        pair = sum(("pod", "data") in tuple(spec)
                   for _, spec in ckpt._items(tr.state_pspecs()))
        out[key + "restore"] = dict(step=tr2.step, leaves=n, bad=bad,
                                    mesh=manifest["extras"]["mesh"],
                                    pair_cut=pair)
    d2 = os.path.join(tmp, key + "ckpt_fail")
    tr = trainer(cfg, meshes[big], {},
                 tc=dict(ckpt_dir=d2, ckpt_every=2, total_steps=8),
                 injector=FailureInjector({3: "node"}))
    res = tr.run(6)
    out[key + "node"] = {k: res[k] for k in ("final_step", "restarts",
                                             "mesh_shape", "left")}
    return out


def slow_replica(cfg, mesh):
    """A 4-step run with ``slow:1`` injected at steps 2-3: the monitor's
    replicas (one a position of the data axes) and the flagged ones."""
    from repro_torch.train.fault import FailureInjector
    tr = trainer(cfg, mesh, {}, tc=dict(total_steps=8),
                 injector=FailureInjector({2: "slow:1", 3: "slow:1"}))
    res = tr.run(4)
    return dict(ewma=len(tr.straggler.ewma),
                events=[e["slow"] for e in res["straggler_events"]])


def straggler_and_sdc(cfgs, meshes, tmp):
    from repro_torch.train.fault import FailureInjector
    cfg, mesh = cfgs["qwen"], meshes[(2, 2)]
    out = {"slow": slow_replica(cfg, mesh),
           "pod_slow": slow_replica(cfg, meshes[(2, 2, 1)])}
    tr = trainer(cfg, mesh, {}, tc=dict(total_steps=8))
    out["clean"] = [e["slow"] for e in tr.run(3)["straggler_events"]]
    d = os.path.join(tmp, "ckpt_sdc")
    tr = trainer(cfg, mesh, {}, tc=dict(total_steps=8, ckpt_dir=d,
                                        ckpt_every=2, sdc_check_every=3),
                 injector=FailureInjector({3: "sdc"}))
    res = tr.run(5)
    out["sdc"] = dict(alarms=res["sdc_alarms"],
                      checksums=len(tr.last_device_checksums),
                      distinct=len(set(tr.last_device_checksums.values())))
    return out


def global_norm(cfgs, meshes):
    """``sharded_global_norm`` of a random gradient tree against the
    unsharded norm."""
    from repro_torch.models.api import Model
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as optim
    out = {}
    for model, shape in (("qwen", (2, 2)), ("moe", (1, 4))):
        mesh = meshes[shape]
        m = Model(cfgs[model], device="cpu")
        g = torch.Generator().manual_seed(7)
        tree = optim.tree_map(lambda s: torch.randn(s.shape, generator=g),
                              m.specs())
        ps = sh.train_pspecs(mesh, m.specs())
        got = coll.sharded_global_norm(sh.shard_tree(tree, ps, mesh), mesh,
                                       ps)
        out[model] = (float(got), float(optim.global_norm(tree)))
    return out


def collective_grads(meshes):
    """Each differentiable collective's backward on (1, 4)'s model group
    against its transpose worked by hand: ``reduce_sum`` the identity,
    ``copy_to_group`` the sum, ``gather`` this rank's slice or the summed
    slice, ``scatter_sum`` the gathered gradient. Returns the max error
    of each."""
    from repro_torch.parallel import collectives as coll
    group = meshes[(1, 4)].groups["model"]
    r = dist.get_rank(group)
    x = torch.arange(8.0).reshape(4, 2) + r
    w = [torch.arange(8.0).reshape(4, 2) * (j + 1) for j in range(4)]
    full_w = torch.cat(w)                      # the weights of every rank
    out = {}

    def grad_of(fn, weight):
        xi = x.clone().requires_grad_(True)
        g, = torch.autograd.grad((fn(xi) * weight).sum(), [xi])
        return g

    out["reduce_sum"] = float((grad_of(lambda v: coll.reduce_sum(v, group),
                                       w[0]) - w[0]).abs().max())
    out["copy_to_group"] = float((grad_of(
        lambda v: coll.copy_to_group(v, group), w[r])
        - sum(w)).abs().max())
    out["gather_slice"] = float((grad_of(lambda v: coll.gather(v, group),
                                         full_w)
                                 - full_w[4 * r:4 * r + 4]).abs().max())
    # rank r's consumer weighs the gathered rows (r + 1) times: summed
    # over the 4 ranks, 10 times
    out["gather_rs"] = float((grad_of(lambda v: coll.gather(
        v, group, backward="reduce_scatter"), full_w * (r + 1))
        - full_w[4 * r:4 * r + 4] * 10).abs().max())
    xs = torch.arange(16.0).reshape(16, 1) + r
    xi = xs.clone().requires_grad_(True)
    y = coll.scatter_sum(xi, group)
    g, = torch.autograd.grad((y * w[r][:, :1]).sum(), [xi])
    out["scatter_sum"] = float((g - torch.cat([v[:, :1] for v in w]))
                               .abs().max())
    return out


def alltoall_bytes(meshes):
    """All-to-all bytes of one MoE layer's forward and backward under
    ``record()``, ``bench_config`` at (1, 4) (4 groups over 4 columns),
    FP8 wire: ``ep_flat`` and ``ep_dedup``."""
    from _torch_ep import bench_config
    from repro_torch.models.api import Model
    from repro_torch.models.param import layer
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import context as C
    from repro_torch.parallel import ep
    from repro_torch.parallel import sharding as sh
    cfg = bench_config()
    mesh = meshes[(1, 4)]
    m = Model(cfg, device="cpu")
    full = layer(m.init(0)["blocks"], 0)["moe"]
    out = {}
    for impl in ("ep_flat", "ep_dedup"):
        ctx = C.ParallelCtx(mesh=mesh, moe_impl=impl, wire="fp8")
        specs = {k: v for k, v in sh.param_pspecs(
            mesh, m.specs(), sh.fsdp_tp_rules(False))["blocks"]["moe"]
            .items()}
        pm = {k: sh.cut_leaf(v, sh.P(*specs[k][1:]), mesh).clone()
              .requires_grad_(k != "bias") for k, v in full.items()}
        x = torch.randn(8, 16, cfg.d_model,
                        generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        with coll.record() as rec, C.use(ctx):
            y, _, _ = ep.moe_ffn_sharded(pm, x, cfg, ctx)
            torch.autograd.grad((y ** 2).sum(),
                                [x] + [v for v in pm.values()
                                       if v.requires_grad])
        a2a = rec.collectives("all_to_all")
        out[impl] = {ph: sum(e.nbytes for e in a2a if e.phase == ph)
                     for ph in ("fwd", "bwd")}
    return out


def dual_counts(cfgs, meshes, inputs):
    """All-to-alls a MoE layer of one loss + backward, single and dual
    (DeepSeek-V3 smoke, ``ep_flat`` at (2, 2)): by layer and pass."""
    from repro_torch.models.api import Model
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import context as C
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as optim
    cfg, mesh = cfgs["moe"], meshes[(2, 2)]
    m = Model(cfg, device="cpu")
    ctx = C.ParallelCtx(mesh=mesh, moe_impl="ep_flat", wire="fp32")
    ps = sh.train_pspecs(mesh, m.specs())
    params = sh.shard_tree(inputs["state:moe"]["params"], ps, mesh)
    leaves = [t.requires_grad_(True) for _, t in optim.tree_items(params)]
    b = {k: torch.from_numpy(v[2 * ctx.index("data"):][:2])
         for k, v in uneven_batch(cfg.vocab_size).items()}
    out = {}
    for dual in (False, True):
        with coll.record() as rec, C.use(dataclasses.replace(
                ctx, zero3=sh.Zero3(mesh, ps))):
            if dual:
                loss, _ = m.loss_dual(params,
                                      {k: v[0::2] for k, v in b.items()},
                                      {k: v[1::2] for k, v in b.items()})
            else:
                loss, _ = m.loss(params, b)
            torch.autograd.grad(loss, leaves, allow_unused=True)
        cnt = {}
        for e in rec.collectives("all_to_all"):
            key = f"{e.layer}|{e.phase}"
            cnt[key] = cnt.get(key, 0) + 1
        out["dual" if dual else "single"] = cnt
    return out


def recorded_steps(cfgs, meshes, inputs):
    """One train step of each of :data:`RECORDED` from the JAX state:
    ``make_train_step`` under the dry run's ctx (``Model.loss`` on this
    data rank's rows, ``seq_axis="model"``), its collectives summed by
    kind as the dry run records them (``dryrun.collective_summary``)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.api import Model
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import context as C
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.trainer import TrainConfig, make_train_step
    out = {}
    for name, (model, shape, kw) in RECORDED.items():
        cfg, mesh = cfgs[model], meshes[shape]
        m = Model(cfg, device="cpu")
        ctx = C.ParallelCtx(mesh=mesh, seq_axis="model", microbatches=1,
                            dp_axes=C.data_axes(mesh.axis_names), **kw)
        ps = sh.train_pspecs(mesh, m.specs(), cfg=cfg)
        params, opt = _state(inputs, model)
        params = sh.shard_tree(params, ps, mesh)
        opt = sh.shard_state(opt, ps, mesh)
        per = BATCH // ctx.dp_size
        d = ctx.dp_index
        b = {k: torch.from_numpy(v[d * per:(d + 1) * per])
             for k, v in recorded_batch(cfg.vocab_size).items()}
        step = make_train_step(m, TrainConfig(**TC), ctx)
        with coll.record() as rec:
            step(params, opt, b, 1)
        out[name] = dryrun.collective_summary(rec)
    return out


def whole_heads_grads(cfgs, meshes, inputs):
    """``Model.loss`` and every logical gradient leaf of smoke qwen3-14b
    with 6 query and 2 KV heads on (1, 4), where the attention runs
    replicated (``sharding.whole_heads``), with and without the sequence
    cut, on :func:`recorded_batch`; and the same on one device."""
    from repro_torch.models.api import Model
    from repro_torch.parallel import context as C
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as optim
    from repro_torch.train.trainer import _tree_of
    cfg, mesh = cfgs["qwen_heads6"], meshes[(1, 4)]
    m = Model(cfg, device="cpu")
    b = {k: torch.from_numpy(v)
         for k, v in recorded_batch(cfg.vocab_size).items()}
    full = inputs["state:qwen_heads6"]["params"]
    ps = sh.train_pspecs(mesh, m.specs(), cfg=cfg)
    out = {}
    for name, seq in (("one", None), ("mesh", None), ("mesh_sp", "model")):
        if name == "one":
            ctx, params = C.ParallelCtx(), optim.tree_map(
                lambda t: t.clone(), full)
        else:
            ctx = C.ParallelCtx(mesh=mesh, seq_axis=seq, microbatches=1,
                                zero3=sh.Zero3(mesh, ps))
            params = sh.shard_tree(full, ps, mesh)
        items = optim.tree_items(params)
        for _, t in items:
            t.requires_grad_(True)
        with C.use(ctx):
            loss, _ = m.loss(params, b)
        grads = torch.autograd.grad(loss, [t for _, t in items])
        tree = _tree_of(items, [g.detach() for g in grads])
        if name != "one":
            tree = logical(tree, ps, mesh)
        out[name] = dict(loss=float(loss), grads=tree)
    return out


def recorded_batch(vocab: int):
    g = np.random.default_rng(2)
    toks = g.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def pipeline(meshes):
    """``pipeline_forward`` and its gradients against the sequential
    stages (the reference's ``test_pipeline_fwd_and_grad``)."""
    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = meshes["pipe"]
    g = torch.Generator().manual_seed(0)
    P, M, mb, d = PIPE["P"], PIPE["M"], PIPE["mb"], PIPE["d"]
    Ws = torch.randn(P, d, d, generator=g) * 0.3
    x = torch.randn(M, mb, d, generator=g)

    def stage(w, x):
        return torch.tanh(x @ w)

    s = mesh.coords["pipe"]
    w = Ws[s].clone().requires_grad_(True)
    with torch.no_grad():
        ref = x
        for i in range(P):
            ref = stage(Ws[i], ref)
    y = pipeline_forward(stage, w, x, mesh)
    g1, = torch.autograd.grad((y ** 2).sum(), [w])
    W2 = Ws.clone().requires_grad_(True)
    r = x
    for i in range(P):
        r = stage(W2[i], r)
    g2, = torch.autograd.grad((r ** 2).sum(), [W2])
    return dict(fwd=float((y - ref).abs().max()),
                grad=float((g1 - g2[s]).abs().max() / g2.abs().max()))


def run_rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    meshes = _meshes()
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    cfgs = configs()
    tmp = os.path.join(out_dir, "shared")
    out = {"dual_pads": dual_pads(cfgs, meshes, inputs)}
    for name, (model, shape, kw) in TRAJ.items():
        steps = 2 if name.endswith("fp8") else STEPS
        out["traj:" + name] = trajectory(cfgs[model], meshes[shape], kw,
                                         _state(inputs, model), steps)
    out["single:qwen"] = trajectory(cfgs["qwen"], None, {},
                                    _state(inputs, "qwen"))
    for fault in FAULTS:
        mesh = meshes[FAULT_MESH[fault]]
        axis = "pod" if fault == "pod_dropped" else "data"
        with planted(fault, mesh.coords[axis]):
            out["fault:" + fault] = trajectory(
                cfgs["qwen"], mesh, {}, _state(inputs, "qwen"))
    out.update(elastic(cfgs, meshes, tmp))
    out.update(elastic(cfgs, meshes, tmp, (2, 2, 1), (1, 2, 1), "pod_"))
    out.update(straggler_and_sdc(cfgs, meshes, tmp))
    out["norm"] = global_norm(cfgs, meshes)
    out["grads"] = collective_grads(meshes)
    out["bytes"] = alltoall_bytes(meshes)
    out["counts"] = dual_counts(cfgs, meshes, inputs)
    out["recorded"] = recorded_steps(cfgs, meshes, inputs)
    out["whole_heads"] = whole_heads_grads(cfgs, meshes, inputs)
    out["pipe"] = pipeline(meshes)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()

