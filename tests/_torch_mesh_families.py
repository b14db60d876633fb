"""Rank body of ``tests/test_torch_mesh_families.py``: every family of the
port under a mesh on 8 gloo ranks on the CPU — mamba2-2.7b and
recurrentgemma-9b (the recurrent blocks tensor-parallel by heads or
channels), llama4-maverick (dense/MoE pairs) and the two families with a
memory, seamless-m4t-large-v2 and llama-3.2-vision-90b — at smoke width.

It imports torch, numpy and the port only, so a spawned rank starts
without JAX. Each rank reads the weights and train states (bridged from
the JAX inits) from ``inputs.pt`` and runs, in turn:

* ``SERVE``: the engine on mesh (2, 4) (``pod_*``: (2, 2, 2), the slots
  over ("pod", "data")), its streams, stats and a CRC of its host mirrors
  and streams;
* ``DISAGG``: cross-mesh disaggregation, prefill on (2, 4) over every
  rank, decode on (1, 4) over ranks 0-3; and, on rank 0, the unmeshed
  disaggregator of the recurrent families;
* on ranks 0-3: ``ssd_block_apply`` and ``recurrent_block_apply`` alone
  on (1, 4), with and without the sequence cut (outputs, caches and every
  gradient leaf made logical); the 3-step ``Trainer`` trajectories of
  ``TRAJ`` on (2, 2); the loss and logical gradients of one meshed step
  of ``GRADS``; and ``chip_smoke.py`` phase (l)'s planted faults on
  (1, 4), with its witness (one device) and its sound readings.

Everything goes to ``rank<r>.pt``.
"""
import dataclasses
import os
import sys
import zlib

import numpy as np
import torch
import torch.distributed as dist

MESH = (2, 4)
POD_MESH = (2, 2, 2)
POD_AXES = ("pod", "data", "model")
SLOTS, MAX_LEN, CHUNK, MAX_NEW = 4, 32, 4, 6
LENGTHS = (3, 5, 6, 8)
FRAMES = (5, 8, 6, 7)
PAGED = dict(paged=True, page_size=8, page_storage="bf16")
EP_FLAT = dict(moe_impl="ep_flat", wire="fp32")
# scenario -> (model, ctx kwargs, engine kwargs)
SERVE = {
    "mamba2": ("mamba2", {}, {}),
    "rglru": ("rglru", {}, {}),
    "llama4_flat": ("llama4", EP_FLAT, {}),
    "llama4_dedup": ("llama4", dict(moe_impl="ep_dedup", wire="fp32"), {}),
    "llama4_overlap": ("llama4", EP_FLAT, dict(decode_overlap=True)),
    "llama4_paged": ("llama4", EP_FLAT, PAGED),
    "llama4_paged_fp8": ("llama4", EP_FLAT, dict(PAGED, page_storage="fp8")),
    "seamless": ("seamless", {}, {}),
    "seamless_paged": ("seamless", {}, PAGED),
    "seamless_paged_fp8": ("seamless", {}, dict(PAGED, page_storage="fp8")),
    "vision": ("vision", {}, {}),
    "pod_mamba2": ("mamba2", {}, {}),
    "pod_rglru": ("rglru", {}, {}),
}
# cross-mesh disaggregation: model -> ctx kwargs
DISAGG = {"mamba2": {}, "llama4": EP_FLAT, "seamless": {}}
DECODE_MESH = (1, 4)
# the train step: 3-step trajectories on (2, 2) over ranks 0-3
TC = dict(peak_lr=1e-3, warmup=2, total_steps=10)
BATCH, SEQ, STEPS = 8, 16, 3
TRAJ = {f"{m}{'_sp' if sp else ''}": (m, dict(kw, seq_axis="model")
                                      if sp else kw)
        for m, kw in (("mamba2", {}), ("rglru", {}), ("llama4", EP_FLAT))
        for sp in (False, True)}
# one meshed step's loss and gradients: name -> (model, mesh, ctx kwargs).
# vision_kv2 has 2 KV heads: at (1, 4) its query heads split and its KV
# heads stay whole on each rank
GRADS = {"seamless": ("seamless", (2, 2), {}),
         "seamless_sp": ("seamless", (2, 2), dict(seq_axis="model")),
         "vision_kv2": ("vision_kv2", (1, 4), {}),
         "vision_kv2_sp": ("vision_kv2", (1, 4), dict(seq_axis="model"))}
# the blocks alone: a batch of 2 x 32 tokens
BLOCK_B, BLOCK_S = 2, 32
# chip_smoke.py phase (l)'s planted faults, at smoke width
FAULTS = {"mamba2-2.7b": ("norm_squares_local", "state_heads_shifted"),
          "recurrentgemma-9b": ("gate_partial_unsummed",)}


def configs():
    from repro_torch.configs.base import get_config, smoke_config
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


def prompts_for(vocab):
    return [np.arange(L) * (i + 3) % vocab for i, L in enumerate(LENGTHS)]


def extras_for(cfg, i, batch=1):
    """Request ``i``'s seeded frames (enc-dec) or patches (vision), numpy
    (batch, rows, d_model); None for the other families."""
    if cfg.family not in ("encdec", "vlm"):
        return None
    rng = np.random.default_rng(100 + i)
    rows, key = ((FRAMES[i % len(FRAMES)], "src_embeds")
                 if cfg.family == "encdec"
                 else (cfg.num_patches, "patch_embeds"))
    return {key: (0.5 * rng.normal(size=(batch, rows, cfg.d_model)))
            .astype(np.float32)}


def train_batch(cfg, seed=2):
    """A (BATCH, SEQ) batch with its extras, numpy."""
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    out.update(extras_for(cfg, 0, BATCH) or {})
    return out


def block_inputs(cfg):
    """(x (B, S, d), the decode token (B, 1, d), the loss weights (B, S,
    d)), numpy fp32."""
    g = np.random.default_rng(7)
    d = cfg.d_model
    return tuple(g.standard_normal(s).astype(np.float32) for s in (
        (BLOCK_B, BLOCK_S, d), (BLOCK_B, 1, d), (BLOCK_B, BLOCK_S, d)))


def _crc(*arrays) -> int:
    c = 0
    for a in arrays:
        c = zlib.crc32(np.ascontiguousarray(a).tobytes(), c)
    return c


def _padded(streams):
    L = max(1, max(len(s) for s in streams))
    return np.array([list(s) + [-1] * (L - len(s)) for s in streams])


STATS = ("steps", "tokens", "prefills", "splices", "first_tokens",
         "page_admits", "page_releases", "peak_pages_used")


def serve(cfg, params, ctx, engine_kw):
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params=params, slots=SLOTS, max_len=MAX_LEN,
                      seed=0, chunk=CHUNK, ctx=ctx, device="cpu",
                      **engine_kw)
    reqs = [Request(i, p, max_new=MAX_NEW)
            for i, p in enumerate(prompts_for(cfg.vocab_size))]
    for i, r in enumerate(reqs):
        eng.submit(r, extras_for(cfg, i))
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert eng.trace_counts["decode"] == 0          # eager under a mesh
    if eng.paged:
        assert eng.free_pages() == eng.pool_pages   # no page leaked
    streams = _padded([r.out for r in reqs])
    return dict(streams=streams,
                stats=np.array([eng.stats[k] for k in STATS]),
                mirrors=_crc(eng.positions, eng._tokens, eng._left,
                             eng._tix, streams))


def serve_disagg(cfg, params, meshes, ctx_kw):
    """Prefill on ``meshes[0]``, decode on ``meshes[1]`` (None: one
    device, no prefill mesh); the streams, -1 rows on a prefill-only
    rank."""
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.disagg import Disaggregator
    from repro_torch.serve.engine import Request
    kw = {} if meshes is None else dict(
        prefill_ctx=ParallelCtx(mesh=meshes[0], **ctx_kw),
        ctx=ParallelCtx(mesh=meshes[1], **ctx_kw))
    dis = Disaggregator(cfg, params=params, decode_slots=3, max_len=MAX_LEN,
                        chunk=CHUNK, device="cpu", **kw)
    reqs = [Request(i, p, max_new=MAX_NEW)
            for i, p in enumerate(prompts_for(cfg.vocab_size))]
    for i, r in enumerate(reqs):
        dis.submit(r, extras_for(cfg, i))
    dis.run()
    if dis.decode is not None:
        assert all(r.done for r in reqs)
    return _padded([r.out for r in reqs])


def _whole(t, spec, mesh):
    """A rank's cut of a cache leaf made whole over the model group."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import Tail
    group = mesh.group_of("model")
    for d, e in enumerate(spec):
        if isinstance(e, Tail):
            t = e.joined(coll.all_gather(t, group, d).chunk(
                mesh.shape["model"], d), d)
        elif e == "model":
            t = coll.all_gather(t, group, d)
    return t


def blocks(cfgs, mesh, inputs):
    """Each recurrent block alone on ``mesh``, on layer 0 of its model's
    weights: the prefill output and cache entries, one decode step's
    output and cache, and every parameter's gradient of ``sum(y * w)``,
    made logical; with (``_sp``) and without the sequence cut."""
    from repro_torch.models import rglru, ssm
    from repro_torch.models.param import layer
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import context as C
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as optim
    from repro_torch.train.trainer import _tree_of
    out = {}
    for model, specs_of, apply, seg, names in (
            ("mamba2", ssm.ssd_block_specs, ssm.ssd_block_apply, ("blocks",),
             ("conv", "state")),
            ("rglru", rglru.recurrent_block_specs,
             rglru.recurrent_block_apply, ("pat", "r0"), ("conv", "h"))):
        cfg = cfgs[model]
        specs = specs_of(cfg, 1)
        ps = sh.train_pspecs(mesh, specs)
        # a layer's placements: the stacked axis dropped
        ps1 = sh.map_with_path(lambda _, p: sh.P(*p[1:]), ps)
        full = sh.at_path(inputs["weights:" + model], seg)
        x, x1, w = (torch.from_numpy(a) for a in block_inputs(cfg))
        cache_specs = sh.explicit_cache_pspecs(
            {"c": {n: torch.empty((1,) + tuple(t.shape), device="meta")
                   for n, t in zip(names, _one_device_entries(
                       apply, cfg, full, x))}}, mesh, ("data",))["c"]
        for sp in (False, True):
            ctx = C.ParallelCtx(mesh=mesh, seq_axis="model" if sp else None)
            params = layer(sh.shard_tree(full, ps, mesh), 0)
            items = optim.tree_items(params)
            for _, t in items:
                t.requires_grad_(True)
            n = mesh.shape["model"]
            r = mesh.coords["model"]
            xin = x[:, r * BLOCK_S // n:(r + 1) * BLOCK_S // n] if sp else x
            with C.use(ctx), C.sequence_sharded(sp):
                y, entries, _ = apply(params, xin, cfg, {"collect_cache": True})
                if sp:
                    y = coll.gather(y, ctx.group("model"), 1,
                                    backward="slice")
                grads = torch.autograd.grad((y * w).sum(),
                                            [t for _, t in items])
            res = dict(y=y.detach(), grads=logical(
                _tree_of(items, [g.detach() for g in grads]), ps1, mesh))
            with torch.no_grad(), C.use(ctx):
                cache = {nm: e.detach().clone()
                         for nm, e in zip(names, entries)}
                res["prefill_cache"] = {
                    nm: _whole(cache[nm], cache_specs[nm][1:], mesh)
                    for nm in names}
                y1, _, _ = apply(params, x1, cfg, {}, cache)
                res["y1"] = y1
                res["decode_cache"] = {
                    nm: _whole(cache[nm], cache_specs[nm][1:], mesh)
                    for nm in names}
            out[model + ("_sp" if sp else "")] = res
    return out


def _one_device_entries(apply, cfg, full, x):
    """The block's prefill cache entries on one device (their global
    shapes)."""
    from repro_torch.models.param import layer
    with torch.no_grad():
        return apply(layer(full, 0), x, cfg, {"collect_cache": True})[1]


def logical(tree, pspecs, mesh):
    """A rank's shards gathered into the logical tree (every rank)."""
    from repro_torch.parallel.sharding import at_path, map_with_path
    from repro_torch.train.checkpoint import _logical
    return map_with_path(lambda path, t: _logical(
        t.detach(), at_path(pspecs, path), mesh).clone(), tree)


def _state(inputs, model):
    from repro_torch.train import optimizer as optim
    st = inputs["state:" + model]
    opt = optim.AdamWState(st["step"], st["master"],
                           optim.tree_map(lambda t: t.bfloat16(), st["m"]),
                           optim.tree_map(lambda t: t.bfloat16(), st["v"]))
    return st["params"], opt


def trajectory(cfg, mesh, ctx_kw, state):
    """``STEPS`` steps from ``state``: losses, grad norms and the logical
    params after."""
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.train import optimizer as optim
    from repro_torch.train.trainer import Trainer, TrainConfig
    tr = Trainer(cfg, TrainConfig(**TC), global_batch=BATCH, seq_len=SEQ,
                 ctx=ParallelCtx(mesh=mesh, **ctx_kw), device="cpu")
    tr.load_state(*state)
    tr.run(STEPS)
    params = logical(tr.params, tr.state_pspecs()["params"], mesh)
    return dict(loss=[h["loss"] for h in tr.history],
                grad_norm=[h["grad_norm"] for h in tr.history],
                params=optim.tree_map(lambda t: t.detach().clone(), params))


def grads_step(cfg, mesh, ctx_kw, full):
    """``Model.loss`` of this data rank's rows of :func:`train_batch` (its
    extras cut with them) and every logical gradient leaf, reduced over
    the data axis as the train step reduces them."""
    from repro_torch.models.api import Model
    from repro_torch.parallel import context as C
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as optim
    from repro_torch.train.trainer import _reduce_over_data, _tree_of
    m = Model(cfg, device="cpu")
    ps = sh.train_pspecs(mesh, m.specs(), cfg=cfg)
    ctx = C.ParallelCtx(mesh=mesh, microbatches=1, zero3=sh.Zero3(mesh, ps),
                        **ctx_kw)
    per = BATCH // ctx.dp_size
    d = ctx.dp_index
    b = {k: torch.from_numpy(v[d * per:(d + 1) * per])
         for k, v in train_batch(cfg).items()}
    params = sh.shard_tree(full, ps, mesh)
    items = optim.tree_items(params)
    for _, t in items:
        t.requires_grad_(True)
    with C.use(ctx):
        loss, _ = m.loss(params, b)
    grads = [g.detach() for g in torch.autograd.grad(
        loss, [t for _, t in items])]
    specs = [sh.at_path(ps, path) for path, _ in items]
    if ctx.dp_group is not None:
        _reduce_over_data(grads, specs, ctx.dp_group, ctx.dp_axes)
    return dict(loss=float(loss.detach()),
                grads=logical(_tree_of(items, grads), ps, mesh))


def faults(mesh):
    """Phase (l)'s readings at smoke width on ``mesh``: each family of
    ``FAULTS`` on one device (the witness) and on the mesh, sound and
    under each planted fault (``chip_smoke.family_run``)."""
    os.environ["CHIP_SMOKE_FAMILY_DEVICE"] = "cpu"
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from repro_torch.parallel.context import ParallelCtx
    out = {}
    for name, planted in FAULTS.items():
        one, witness = chip_smoke.family_run(torch, name, "cpu")
        run, readings = chip_smoke.family_run(
            torch, name, "cpu", ParallelCtx(mesh=mesh), faults=planted,
            firsts=[o[0] for o in one["outs"]])
        out[name] = dict(witness=witness["sound"], readings=readings,
                         witness_outs=one["outs"], outs=run["outs"])
    return out


def run_rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    from repro_torch.parallel.context import Mesh, ParallelCtx, data_axes
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = Mesh.create(MESH)
    pod_mesh = Mesh.create(POD_MESH, POD_AXES)
    decode_mesh = Mesh.create(DECODE_MESH, ranks=range(4))
    mesh22 = Mesh.create((2, 2), ranks=range(4))
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                        weights_only=False)
    cfgs = configs()
    weights = {m: inputs["weights:" + m] for m in cfgs}
    out = {}
    for name, (model, ctx_kw, engine_kw) in SERVE.items():
        m = pod_mesh if name.startswith("pod_") else mesh
        ctx = ParallelCtx(mesh=m, dp_axes=data_axes(m.axis_names), **ctx_kw)
        out["serve:" + name] = serve(cfgs[model], weights[model], ctx,
                                     engine_kw)
    for model, ctx_kw in DISAGG.items():
        out["disagg:" + model] = serve_disagg(
            cfgs[model], weights[model], (mesh, decode_mesh), ctx_kw)
    if rank == 0:
        for model in ("mamba2", "rglru"):
            out["disagg_one:" + model] = serve_disagg(
                cfgs[model], weights[model], None, {})
    if rank < 4:
        out["blocks"] = blocks(cfgs, decode_mesh, inputs)
        for name, (model, ctx_kw) in TRAJ.items():
            out["traj:" + name] = trajectory(cfgs[model], mesh22, ctx_kw,
                                             _state(inputs, model))
        for name, (model, shape, ctx_kw) in GRADS.items():
            out["grads:" + name] = grads_step(
                cfgs[model], mesh22 if shape == (2, 2) else decode_mesh,
                ctx_kw, weights[model])
        out["faults"] = faults(decode_mesh)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
