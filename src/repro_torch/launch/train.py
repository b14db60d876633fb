"""Training launcher — the port of ``repro.launch.train``:
``PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--smoke]
[--steps N] [--mesh DxM] [--device cpu] ...``

The reference's flags and its two printed lines. ``--mesh DxM`` spawns
D*M ranks (gloo over a ``FileStore`` in a temporary directory, as
``launch/serve.py`` does; on the card they share it), each training its
cut of the FSDP x TP state with EP MoE; rank 0 prints. ``--mesh PxDxM``
is the mesh (pod, data, model): the batch and the ZeRO-3 cut run over the
pair ``("pod", "data")``, as the reference's ``dp_axes``. ``--devices N``
is the reference's forced XLA host-device count, which means nothing to
torch: it is accepted so the reference's command lines run, and raises
only where it is smaller than the mesh, as the reference's mesh
construction does. ``--device`` (the port's own) is
``cuda`` unless ``cpu`` is asked for.
"""
from __future__ import annotations

import argparse
import math
from typing import Any, Dict, Optional, Sequence

from repro_torch.launch.serve import rank_main, rank_threads, spawn_ranks


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--devices", type=int, default=0,
                    help="the reference's forced host device count: "
                         "accepted, and checked against the mesh size")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x4 -> mesh (data=2, model=4) with EP MoE, "
                         "2x1x2 -> (pod=2, data=1, model=2); one spawned "
                         "rank a position")
    ap.add_argument("--moe-impl", default="ep_dedup",
                    help="local | ep_flat | ep_dedup (EP dispatch protocol"
                         " used by the meshed train step)")
    ap.add_argument("--wire", default="fp8",
                    help="EP dispatch wire precision: fp8 | bf16 | fp32")
    ap.add_argument("--microbatches", type=int, default=2, choices=(1, 2),
                    help="2 = dual anti-phase microbatch overlap (paper"
                         " §2.3.1); 1 = single-batch step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from repro_torch.configs.base import get_config, smoke_config
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    return run(cfg, args)


def _axes(shape):
    return (("data", "model") if len(shape) == 2
            else ("pod", "data", "model"))


def run(cfg, args, params=None) -> Dict[str, Any]:
    """Train ``args.steps`` steps of ``cfg`` as the CLI does and print the
    reference's lines; returns the trainer's ``run`` output (rank 0's on a
    mesh). ``params``: the starting weights of a single-process run, with
    a fresh optimizer state (None: drawn from the seed)."""
    from repro_torch.device import resolve_device
    from repro_torch.parallel.context import ParallelCtx
    resolve_device(args.device)
    if not args.mesh:
        out = train(cfg, args, ParallelCtx(), params)
    elif params is not None:
        raise ValueError("params= with --mesh: each rank draws its own "
                         "cut of the seeded state")
    else:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        if args.devices and args.devices < math.prod(shape):
            raise ValueError(f"--devices {args.devices} is fewer than the "
                             f"{math.prod(shape)} positions of mesh "
                             f"{shape}")
        world = math.prod(shape)
        out = spawn_ranks(rank_main, world, (_train_body, rank_threads(world),
                                             cfg, args, shape))[0]
    h = out["history"]
    print(f"[train] {args.arch}: step {out['final_step']}, "
          f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}, "
          f"restarts {out['restarts']}")
    if args.mesh:
        print(f"[train] mesh {out['mesh_shape']} moe_impl={args.moe_impl} "
              f"wire={args.wire} microbatches={args.microbatches} "
              f"straggler_events={len(out['straggler_events'])}")
    return out


def train(cfg, args, ctx, params=None) -> Dict[str, Any]:
    from repro_torch.train.trainer import Trainer, TrainConfig
    tc = TrainConfig(peak_lr=args.lr, warmup=max(args.steps // 10, 1),
                     total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=max(args.steps // 4, 1))
    tr = Trainer(cfg, tc, global_batch=args.batch, seq_len=args.seq,
                 ctx=ctx, device=args.device)
    if params is not None:
        tr.load_state(params)
    return tr.run(args.steps)


def _train_body(cfg, args, shape):
    import torch.distributed as dist
    from repro_torch.parallel.context import Mesh, ParallelCtx, data_axes
    axes = _axes(shape)
    ctx = ParallelCtx(mesh=Mesh.create(shape, axes), dp_axes=data_axes(axes),
                      moe_impl=args.moe_impl if cfg.moe else "local",
                      wire=args.wire, microbatches=args.microbatches)
    out = train(cfg, args, ctx)
    return out if dist.get_rank() == 0 else None


if __name__ == "__main__":
    main()
