"""Multi-pod dry run — the port of ``repro.launch.dryrun``.

For every (architecture x input shape) cell, trace one rank's step on the
production mesh on ``meta`` tensors (nothing allocated) inside a fake
``torch.distributed`` world of the mesh's size, in which this process is
rank 0 and every collective moves nothing; under SPMD every rank's shapes
and collectives are rank 0's. The trace counts the step's FLOPs (by
``torch.utils.flop_counter.FlopCounterMode``'s formulas), the bytes its
ops read and write, the rank's argument bytes and the peak of its live temporaries
(:class:`StepMeter`), and its collectives by kind
(``parallel/collectives.record``), and writes everything to
``results/dryrun_torch/*.json`` for the roofline report
(``launch/roofline.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch yi-34b]
        [--shape train_4k] [--multi-pod] [--moe-impl ep_dedup]
        [--remat full] [--out results/dryrun_torch]

Phase -> step fn:
    train_4k      train step (``Model.loss`` + gradients + AdamW update,
                  ``train/trainer.make_train_step``: FSDP x TP placements,
                  ZeRO-3 gathers, remat=full, the sequence cut over model)
    prefill_32k   ``Model.prefill`` (logits + cache assembly)
    decode_32k / long_500k    ``Model.decode_step`` (one token against the
                  dense cache; ``ep_ftp``)

The step runs the plain route: the reference's dry run lowers with an
empty ``impl_ctx``, so the hand-written kernels are not on this path and
the FLOPs counted are the plain versions' arithmetic. Every family
traces under the mesh; a cell that fails (an ``--expert-dtype`` cell:
ROADMAP.md A.3) records its error, as the reference records a failed
cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import (SHAPES, get_config, list_archs,
                                      shape_applicable)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.api import Model
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx_mod
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as optim

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the port's collective kinds (``collectives.record``) under the
# reference's HLO names
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "exchange": "collective-permute"}

BACKEND = "repro_dryrun"


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def _register_backend() -> None:
    """A ``torch.distributed`` backend whose process groups move nothing:
    torch's own ``FakeProcessGroup``, registered for the ``meta`` device
    too (the stock ``fake`` backend's registration leaves it out, which
    point-to-point calls need)."""
    if BACKEND in dist.Backend.backend_list:
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        make = getattr(FakeProcessGroup, "_create_internal", None)
        if make is not None:
            return make(common_opts.group_rank, common_opts.group_size,
                        backend_opts)
        return FakeProcessGroup(common_opts.group_rank,
                                common_opts.group_size)

    dist.Backend.register_backend(BACKEND, create, extended_api=True,
                                  devices=["cpu", "cuda", "meta"])


@contextlib.contextmanager
def fake_world(size: int):
    """A world of ``size`` ranks in this process, as rank 0, over the fake
    backend; destroyed on the way out, so no default process group
    outlives the block. Refuses to run inside an initialized world."""
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake world: a default "
                           "process group is initialized already")
    _register_backend()
    dist.init_process_group(BACKEND, store=dist.HashStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the meter
# ---------------------------------------------------------------------------


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepMeter(TorchDispatchMode):
    """Counts, over the ops dispatched in its scope: ``flops``, each op's
    FLOPs by ``FlopCounterMode``'s own formulas
    (``torch.utils.flop_counter.flop_registry``, the same count at a
    third less dispatch time than stacking that mode; the tests and the
    card's phase (k.2) hold the two equal); ``bytes``, the bytes of every
    op's tensor inputs and outputs (views excluded: an upper bound on the
    HBM traffic, the role of XLA's "bytes accessed"); ``peak``, the most
    bytes of storage made in its scope and alive at once (the storages of
    the arguments, made before, are not counted). A storage counts from
    the op that made it until it is freed."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_of = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}

    def exclude(self, tree) -> None:
        """Storages of ``tree`` (the step's arguments) are not new."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._known.setdefault(_storage_key(t), 0)

    def _free(self, key: int) -> None:
        self.live -= self._known.pop(key, 0)
        self._refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self._flop_of.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.is_view:              # moves nothing, makes no storage
            return out
        outs = _tensors(out)
        for t in _tensors(args) + _tensors(kwargs) + outs:
            self.bytes += t.numel() * t.element_size()
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._known[key] = n
            self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        return out


def _tensors(x) -> list:
    """The tensors of an op's arguments or result (flat, or in lists,
    tuples and dicts one level down, as ATen passes them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return []
    out = []
    for v in x:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def collective_summary(rec: coll.Record) -> Dict[str, object]:
    """A record's collectives as the reference's ``collective_bytes``
    gives them: bytes a rank by kind (a collective's result bytes; a
    reduce-scatter's input bytes), ``counts`` (collectives issued, not HLO
    ops) and ``total``."""
    out: Dict[str, object] = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for e in rec.collectives():
        kind = KINDS[e.kind]
        n = e.nbytes
        if e.kind == "all_gather":
            n *= dist.get_world_size(e.group)
        out[kind] += float(n)
        counts[kind] += 1
    out["counts"] = counts
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def measure(step_fn, args) -> dict:
    """Run ``step_fn(*args)`` once under the meter and the collective
    record. Returns the record's measured fields."""
    meter = StepMeter()
    meter.exclude(args)
    t0 = time.perf_counter()
    with coll.record() as rec, meter:
        out = step_fn(*args)
    arg_bytes = tree_bytes(args)
    arg_keys = {_storage_key(t) for t in tree_leaves(args)
                if isinstance(t, torch.Tensor)}
    alias = sum({_storage_key(t): t.untyped_storage().nbytes()
                 for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                 and _storage_key(t) in arg_keys}.values())
    temp = meter.peak
    return dict(
        trace_s=round(time.perf_counter() - t0, 3),
        flops_per_device=float(meter.flops),
        bytes_per_device=float(meter.bytes),
        memory_analysis=dict(
            argument_size_in_bytes=int(arg_bytes),
            output_size_in_bytes=int(tree_bytes(out)),
            temp_size_in_bytes=int(temp),
            # nothing is compiled: no generated code
            generated_code_size_in_bytes=0,
            alias_size_in_bytes=int(alias)),
        collectives=collective_summary(rec))


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _local(tree, pspecs, mesh):
    """Meta tensors of this rank's shard shapes of a global meta tree."""
    return shd.map_with_path(
        lambda path, t: torch.empty(
            shd.local_shape(tuple(t.shape), shd.at_path(pspecs, path), mesh),
            dtype=t.dtype, device="meta"), tree)


def mesh_label(multi_pod: bool) -> str:
    return "x".join(map(str, mesh_mod.production_shape(multi_pod)[0]))


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               moe_impl: str = "ep_dedup", remat: str = "full",
               fp8: Optional[bool] = None, cache_dtype: str = "",
               wire: str = "fp8", expert_dtype: str = "",
               pin_attn: bool = True):
    """Returns ``(step_fn, args, ctx, mesh, model)`` for a cell, inside the
    fake world: this rank's shards of the arguments as meta tensors. The
    reference's cell: its config overrides, rules and ctx fields."""
    cfg = get_config(arch)
    if fp8 is not None:
        cfg = dataclasses.replace(cfg, fp8=fp8)
    if cache_dtype:
        cfg = dataclasses.replace(cfg, cache_dtype=cache_dtype)
    if expert_dtype:
        cfg = dataclasses.replace(cfg, expert_dtype=expert_dtype, fp8=False)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    step_fn, args, ctx, model = build_step(
        cfg, SHAPES[shape_name], mesh, moe_impl=moe_impl, remat=remat,
        wire=wire, pin_attn=pin_attn)
    return step_fn, args, ctx, mesh, model


def build_step(cfg, shape, mesh, *, moe_impl: str = "ep_dedup",
               remat: str = "full", wire: str = "fp8",
               pin_attn: bool = True):
    """``(step_fn, args, ctx, model)`` of ``cfg`` at ``shape`` on ``mesh``
    (a mesh of the initialized fake world): the reference's ctx fields
    (``remat`` and the sequence cut over model for train, ``ep_ftp`` for
    decode), the phase's rules with the layouts explicit SPMD needs, and
    this rank's shards of the arguments as meta tensors."""
    dp = mesh_mod.dp_axes_for(mesh)
    model = Model(cfg, device="meta")
    phase = shape.phase
    ctx = pctx_mod.ParallelCtx(
        mesh=mesh, dp_axes=dp, ep_axis="model",
        moe_impl=(moe_impl if cfg.moe else "local"),
        ep_ftp=(phase == "decode"), wire=wire, pin_attn=pin_attn,
        remat=(remat if phase == "train" else "none"),
        seq_axis=("model" if phase == "train" else None),
        # the reference's train step is ``Model.loss`` on the whole batch
        microbatches=1)
    specs = model.specs()
    if phase == "decode":
        # the meshed engine's placement: the reference's decode rules with
        # the layouts explicit SPMD needs
        from repro_torch.serve.engine import serve_param_pspecs
        pspecs = serve_param_pspecs(cfg, ctx, specs)
    else:
        pspecs = shd.whole_heads(cfg, mesh, specs, shd.param_pspecs(
            mesh, specs, shd.rules_for(cfg, phase, "pod" in mesh.shape)))
    params = _local(model.param_structs(), pspecs, mesh)
    inputs = model.input_specs(shape)
    cache = inputs.pop("cache", None)
    batch = {k: _local(v, shd.batch_pspec(mesh, v.shape[0], dp, v.dim()),
                       mesh) for k, v in inputs.items()}

    if phase == "train":
        from repro_torch.train.trainer import TrainConfig, make_train_step
        step = make_train_step(model, TrainConfig(), ctx)
        opt = optim.init(params)

        def train_step(params, opt_state, batch):
            params, opt_state, metrics = step(params, opt_state, batch, 1)
            return params, opt_state, metrics["loss"]
        return train_step, (params, opt, batch), ctx, model

    if phase == "prefill":
        # the prefill rules cut the weights over data (FSDP): each layer's
        # cut is gathered as the model reaches it
        pctx = dataclasses.replace(ctx, zero3=shd.Zero3(mesh, pspecs))

        def prefill_step(params, batch):
            return model.prefill(params, batch, pctx=pctx)
        return prefill_step, (params, batch), ctx, model

    cps = shd.explicit_cache_pspecs(cache, mesh, dp)
    cache = _local(cache, cps, mesh)

    def serve_step(params, cache, tokens, positions):
        return model.decode_step(params, cache, tokens, positions, pctx=ctx,
                                 batch_sharded=True)
    return serve_step, (params, cache, batch["tokens"],
                        batch["positions"]), ctx, model


def trace(cfg, shape, mesh_shape, axis_names=("data", "model"),
          **kw) -> dict:
    """The measured fields of one rank's step of ``cfg`` at ``shape`` on a
    mesh of ``mesh_shape`` (:func:`build_step`'s keywords), traced in a
    fake world of its size: a cell of any config, shape and mesh."""
    with fake_world(math.prod(mesh_shape)):
        mesh = pctx_mod.Mesh.create(tuple(mesh_shape), tuple(axis_names))
        step_fn, args, _, _ = build_step(cfg, shape, mesh, **kw)
        return dict(measure(step_fn, args), devices=mesh.size)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             moe_impl: str = "ep_dedup", remat: str = "full",
             out_dir: str = "results/dryrun_torch", tag: str = "",
             fp8: Optional[bool] = None, cache_dtype: str = "",
             wire: str = "fp8", expert_dtype: str = "",
             pin_attn: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "mesh": mesh_label(multi_pod), "moe_impl": moe_impl,
           "remat": remat, "tag": tag, "cache_dtype": cache_dtype,
           "expert_dtype": expert_dtype, "backend": "torch",
           # a GSPMD hint in the reference: explicit SPMD computes a rank's
           # heads from its own column slices either way (what True pins)
           "pin_attn": pin_attn}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    try:
        size = math.prod(mesh_mod.production_shape(multi_pod)[0])
        with fake_world(size):
            step_fn, args, ctx, mesh, model = build_cell(
                arch, shape_name, multi_pod=multi_pod, moe_impl=moe_impl,
                remat=remat, fp8=fp8, cache_dtype=cache_dtype, wire=wire,
                expert_dtype=expert_dtype, pin_attn=pin_attn)
            got = measure(step_fn, args)
        rec.update(status="ok", devices=int(mesh.size), **got)
        # the XLA-only keys: no HLO is lowered or compiled here, and no
        # f32 staging copy of a bf16 GEMM's operands is made (that
        # artifact is XLA:CPU's), so the temp figure needs no correction
        rec.update(f32_staging_bytes=0, hlo_bytes=0)
        rec["temp_corrected"] = rec["memory_analysis"]["temp_size_in_bytes"]
        print(f"[dryrun] {arch} x {shape_name} pod={multi_pod} OK "
              f"trace={rec['trace_s']:.1f}s "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"coll={rec['collectives']['total']/1e6:.1f}MB/dev")
        print(f"  memory_analysis: {rec['memory_analysis']}")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} x {shape_name} pod={multi_pod} FAILED: "
              f"{type(e).__name__}: {str(e)[:300]}")
    rec.setdefault("wall_s", round(time.time() - t0, 3))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "_pod" if multi_pod else ""
        tagstr = f"_{tag}" if tag else ""
        fn = f"{arch}__{shape_name}{suffix}{tagstr}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-impl", default="ep_dedup",
                    choices=["ep_flat", "ep_dedup", "local"])
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--fp8", default=None, choices=["on", "off"])
    ap.add_argument("--cache-dtype", default="")
    ap.add_argument("--wire", default="fp8", choices=["fp8", "bf16", "fp32"])
    ap.add_argument("--expert-dtype", default="")
    ap.add_argument("--no-pin-attn", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    fp8 = None if args.fp8 is None else (args.fp8 == "on")

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                results.append(run_cell(
                    arch, shape, multi_pod=mp, moe_impl=args.moe_impl,
                    remat=args.remat, out_dir=args.out, tag=args.tag,
                    fp8=fp8, cache_dtype=args.cache_dtype,
                    wire=args.wire, expert_dtype=args.expert_dtype,
                    pin_attn=not args.no_pin_attn))
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\n[dryrun] done: {ok} ok, {skip} skipped, {err} errors "
          f"of {len(results)} cells")
    return 0 if err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
