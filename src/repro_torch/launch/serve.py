"""Serving launcher — the port of ``repro.launch.serve``: fused-chunk
batched decode with optional MTP speculative drafting and prefill/decode
disaggregation, on the card by default.

``PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b
[--smoke] [--requests 8] [--paged] [--disagg] [--mtp] [--chunk 8]
[--temperature 0.7] [--device cpu]``

Every flag of the reference keeps its name, default and meaning, and
every line it prints keeps its format. Requests are queued with
``submit()``; ``step()``/``run_until_done()`` admit them into slots
(bucketed prefill + splice, or page admission) and drive fused k-step
decode chunks, one CUDA graph replay a chunk on the card.

``--paged [--page-size 8] [--pool-pages N] [--page-storage fp8|bf16]``
swaps in the paged block-pool cache (page-granular admission plus FP8
page storage); ``--host-tier-pages N`` puts a host-memory tier of N pages
behind it. ``--gateway N`` serves through N engine replicas (one shared
parameter set) behind the fault-tolerant gateway; ``--chaos
"6=crash:0,9=slow:1"`` injects faults on its tick clock (the grammar of
``repro_torch/faultspec.py``).

``--mesh D,M`` shards serving over a ``(data, model)`` mesh. The port
runs one process per mesh position, so the launcher spawns D*M ranks
itself (gloo over a ``FileStore`` in a temporary directory; on the card
the ranks share it); rank 0 prints. With ``--disagg``, ``--prefill-mesh
D',M'`` puts the prefill pool on its own mesh: the launcher spawns
max(D*M, D'*M') ranks, the prefill mesh over the first D'*M' and the
decode mesh over the first D*M (the port's ``Disaggregator`` needs every
rank on the prefill mesh, and refuses otherwise). A rank that fails ends
the command with its traceback.

The port's own flags: ``--device`` (``cuda`` unless ``cpu`` is asked for;
without a card ``cuda`` raises), ``--attn-impl pallas`` (decode attention
and GQA prefill through the registry's hand-written kernels) and
``--fp8-impl pallas`` (the FP8 linears through ``fp8_gemm``).

:func:`main` parses the arguments and calls :func:`run`, which returns
the requests, the engine and its stats; a caller with its own config
(a depth cut) and prepared weights calls :func:`run` directly.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np


def mesh_shape(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """'D,M' (or launch/train.py's 'DxM') -> (D, M); None passes through
    (the single-device default). The reference's messages on a bad spec."""
    if not spec:
        return None
    try:
        shape = tuple(int(s) for s in spec.replace("x", ",").split(","))
    except ValueError:
        raise SystemExit(f"--mesh expects 'D,M' or 'DxM' (got {spec!r})")
    if len(shape) != 2:
        raise SystemExit(f"--mesh expects 'D,M' or 'DxM' (got {spec!r})")
    return shape


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--mtp", action="store_true")
    ap.add_argument("--disagg", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--page-storage", default="fp8",
                    choices=("fp8", "bf16"))
    ap.add_argument("--host-tier-pages", type=int, default=None,
                    metavar="N",
                    help="paged only: host-memory KV tier of N pages "
                         "behind the device pool — suspended requests and "
                         "cold prefix pages spill over the staged PCIe hop "
                         "and prefetch back")
    ap.add_argument("--gateway", type=int, default=0, metavar="N",
                    help="serve through N engine replicas behind the "
                         "fault-tolerant gateway")
    ap.add_argument("--chaos", default=None, metavar="T=KIND[:R],..",
                    help="gateway only: inject faults on the tick clock, "
                         "e.g. '6=crash:0,9=slow:1' (kinds: crash, hang, "
                         "slow, flaky-admit, pcie_slow, pcie_drop, "
                         "tier_full — the tier kinds need "
                         "--host-tier-pages)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="gateway only: re-dispatch budget per request")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="shard serving over a (data, model) mesh of D*M "
                         "spawned ranks, e.g. '2,4' (default: one device)")
    ap.add_argument("--prefill-mesh", default=None, metavar="D,M",
                    help="disagg only: separate mesh for the prefill "
                         "pool (cross-mesh handoff via host)")
    ap.add_argument("--moe-impl", default="ep_flat",
                    choices=("local", "ep_flat", "ep_dedup"),
                    help="MoE dispatch when meshed (ignored unmeshed)")
    ap.add_argument("--wire", default="fp8",
                    choices=("fp8", "bf16", "fp32"),
                    help="EP dispatch wire precision when meshed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the plain PyTorch path)")
    ap.add_argument("--attn-impl", default="", choices=("", "pallas"),
                    help="'pallas': paged decode attention and GQA prefill "
                         "through the hand-written kernels")
    ap.add_argument("--fp8-impl", default="ref", choices=("ref", "pallas"),
                    help="'pallas': the FP8 linears through fp8_gemm")
    return ap


def check(args) -> None:
    """The reference's refusals of flag combinations, in its order and
    with its words."""
    if args.host_tier_pages is not None:
        if not args.paged:
            raise SystemExit("--host-tier-pages requires --paged")
        if args.disagg:
            raise SystemExit("--host-tier-pages does not apply to the "
                             "--disagg decode pool yet")
    mesh_shape(args.mesh)
    if args.prefill_mesh and not args.disagg:
        raise SystemExit("--prefill-mesh only applies with --disagg")
    if args.chaos and not args.gateway:
        raise SystemExit("--chaos only applies with --gateway")
    if args.gateway and (args.disagg or args.mesh):
        raise SystemExit("--gateway replicas are single-device "
                         "engines (no --disagg/--mesh)")


def config(args):
    from repro_torch.configs.base import get_config, smoke_config
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    return dataclasses.replace(cfg, fp8_impl=args.fp8_impl)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    return run(config(args), args)


def run(cfg, args, params=None) -> Dict[str, Any]:
    """Serve ``args.requests`` requests of ``cfg`` as the CLI does and
    print the reference's lines. Returns ``requests`` (the engine's, or
    the gateway's), ``engine`` (the decode engine, the gateway, or None
    for a meshed run, whose engines live in the ranks) and ``stats``.
    ``params``: weights for the single-process runs (None: drawn from the
    seed, as the reference's engine does)."""
    check(args)
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    if args.mesh or args.prefill_mesh:
        if params is not None:
            raise ValueError("params= with --mesh: each rank draws its own "
                             "slices of the seeded weights")
        return _spawn(cfg, args)
    return serve(cfg, args, params, print)


def paged_kwargs(args) -> Dict[str, Any]:
    kw = dict(paged=args.paged, page_size=args.page_size,
              pool_pages=args.pool_pages, page_storage=args.page_storage)
    if args.host_tier_pages is not None:
        kw["host_tier_pages"] = args.host_tier_pages
    return kw


def prompts(cfg, n: int):
    return [(np.arange(5 + i * 2) * (i + 3)) % cfg.vocab_size
            for i in range(n)]


def serve(cfg, args, params, emit: Callable[[str], None], ctx=None,
          prefill_ctx=None) -> Dict[str, Any]:
    """One process's run: the gateway, the disaggregated pools or one
    engine, with ``ctx``/``prefill_ctx`` the rank's mesh contexts."""
    from repro_torch.serve.disagg import Disaggregator
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.speculative import measured

    common = dict(max_len=args.max_len, chunk=args.chunk,
                  temperature=args.temperature, top_k=args.top_k,
                  attn_impl=args.attn_impl, device=args.device,
                  **paged_kwargs(args))
    if args.gateway:
        return serve_gateway(cfg, args, params, emit, common)

    reqs = [Request(i, p, max_new=args.max_new)
            for i, p in enumerate(prompts(cfg, args.requests))]
    if args.disagg:
        dis = Disaggregator(cfg, params=params, decode_slots=args.slots,
                            use_mtp=args.mtp, ctx=ctx,
                            prefill_ctx=prefill_ctx, **common)
        for r in reqs:
            dis.submit(r)
        dis.run()
        prefill_eng = dis.prefill_pool
        eng = dis.decode
        if eng is None:          # a rank off the decode mesh: prefill only
            return dict(requests=reqs, engine=None, stats=None)
        stats = eng.stats
        if dis.cross_mesh:
            # prefills ran on the separate prefill pool: its counters too
            emit(f"[serve] disaggregated (cross-mesh): handoff "
                 f"{dis.handoff_bytes / 1e6:.2f} MB, decode {stats}, "
                 f"prefill {prefill_eng.stats}")
        else:
            emit(f"[serve] disaggregated: handoff "
                 f"{dis.handoff_bytes / 1e6:.2f} MB, {stats}")
    else:
        eng = ServeEngine(cfg, params=params, slots=args.slots,
                          use_mtp=args.mtp, ctx=ctx, **common)
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        emit(f"[serve] {eng.stats} acceptance="
             f"{eng.acceptance_rate():.2f}")
        prefill_eng = eng
    if eng.meshed:
        emit(f"[serve] sharded over mesh {dict(eng.ctx.mesh.shape)} "
             f"(EP degree {eng.ctx.model_size}), "
             f"moe_impl={args.moe_impl}, wire={args.wire}, decode "
             f"all-to-all {eng.decode_alltoall_bytes()} B/step (counted)")
    # admission-side dispatches, as the port counts them: a prefill (its
    # page quantization included) and one admission (splice or page
    # install) each; what is left is fused decode chunks per token
    s = eng.stats
    admit = s["prefills"] + s["splices"] + s["page_admits"]
    decode_tokens = s["tokens"] - s["first_tokens"]
    if decode_tokens:
        emit(f"[serve] decode dispatches/token = "
             f"{(s['dispatches'] - admit) / decode_tokens:.3f} "
             f"(chunk={args.chunk}, prefill buckets compiled: "
             f"{prefill_eng.compiled_prefill_buckets})")
    if args.paged:
        emit(f"[serve] paged cache ({args.page_storage}): "
             f"{eng.cache_bytes_per_token():.0f} B/token, "
             f"pool {eng.pool_stats()}, "
             f"peak pages {s['peak_pages_used']}")
    if args.host_tier_pages is not None:
        ts = eng.tier_stats()
        emit(f"[serve] host tier ({args.host_tier_pages} pages): "
             f"suspensions {ts['suspensions']}, resumes {ts['resumes']}, "
             f"spilled {ts['spilled_pages']}p/{ts['spill_bytes']}B, "
             f"fetched {ts['fetched_pages']}p/{ts['fetch_bytes']}B, "
             f"stalls {ts['prefetch_stalls']}, degraded {ts['degraded']}, "
             f"peak resident {ts['peak_resident_pages']}p "
             f"(device pool {eng.pool_pages}p)")
    if args.mtp and not eng.use_mtp:
        emit(f"[serve] --mtp ignored: {cfg.name} has no MTP module")
    elif args.mtp:
        m = measured(eng)
        emit(f"[serve] MTP speedup model: acceptance={m.acceptance:.2f} "
             f"-> {m.tps_multiplier:.2f}x TPS")
    for r in reqs[:3]:
        emit(f"  req {r.rid}: prompt {list(r.prompt[:6])}... -> "
             f"{r.out[:args.max_new]}")
    return dict(requests=reqs, engine=eng, stats=s)


def serve_gateway(cfg, args, params, emit, common) -> Dict[str, Any]:
    from repro_torch import faultspec
    from repro_torch.serve.fault import ServeFaultInjector
    from repro_torch.serve.gateway import Gateway

    injector = None
    if args.chaos:
        injector = ServeFaultInjector(faultspec.parse_schedule(
            args.chaos, faultspec.SERVE_KINDS))
    gw = Gateway(cfg, params=params, replicas=args.gateway,
                 slots=args.slots, max_retries=args.max_retries,
                 injector=injector, **common)
    grs = [gw.submit(p, max_new=args.max_new)
           for p in prompts(cfg, args.requests)]
    gw.run_until_done()
    s = gw.stats
    emit(f"[serve] gateway x{args.gateway}: "
         f"{s['completed']}/{s['submitted']} done in {s['ticks']} "
         f"ticks, retries {s['retries']}, deaths "
         f"{s['replica_deaths']}, shed {s['shed']}, timed_out "
         f"{s['timed_out']}, affinity {s['affinity_hits']}")
    emit(f"[serve] replica health: {gw.registry.states()}")
    if injector is not None and injector.events:
        emit(f"[serve] chaos fired: {injector.events}")
    if args.host_tier_pages is not None:
        for rep in gw.registry.replicas.values():
            ts = rep.engine.tier_stats()
            emit(f"[serve] replica {rep.rid} tier: suspensions "
                 f"{ts['suspensions']}, resumes {ts['resumes']}, "
                 f"stalls {ts['prefetch_stalls']}, degraded "
                 f"{ts['degraded']}, retries {ts['retries']}, "
                 f"host occupancy {ts['host_occupancy']:.2f}")
    for g in grs[:3]:
        emit(f"  req {g.gid}: prompt {list(g.prompt[:6])}... -> "
             f"{g.delivered[:args.max_new]} [{g.state}]")
    return dict(requests=grs, engine=gw, stats=s)


# --- the meshed run: one spawned process per mesh position -------------------


def spawn_ranks(target, world: int, args: tuple) -> list:
    """Run ``target(rank, world, store, out, *args)`` in ``world`` spawned
    processes that meet over a gloo ``FileStore`` in a temporary directory;
    returns what each rank wrote to ``out`` (pickled). The first rank to
    fail ends the others at once (they would wait in a collective) and
    raises ``SystemExit`` with its traceback."""
    mp = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [mp.Process(target=target,
                            args=(r, world, store, outs[r]) + args)
                 for r in range(world)]
        for p in procs:
            p.start()
        failed = None
        try:
            while failed is None and any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                time.sleep(0.05)
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), failed)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        if failed is not None:
            err = outs[failed] + ".err"
            tb = (open(err).read() if os.path.exists(err)
                  else f"exit code {procs[failed].exitcode}\n")
            raise SystemExit(f"rank {failed} of {world} failed:\n{tb}")
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def rank_main(rank: int, world: int, store: str, out: str, body,
              threads: int, *args) -> None:
    """A spawned rank: join the gloo group, run ``body(*args)``, write its
    result; on an error write the traceback beside ``out`` and exit 1."""
    import torch
    import torch.distributed as dist
    try:
        torch.set_num_threads(threads)
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        result = body(*args)
        dist.barrier()
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def rank_threads(world: int) -> int:
    import torch
    return max(1, torch.get_num_threads() // world)


def _spawn(cfg, args) -> Dict[str, Any]:
    decode, prefill = mesh_shape(args.mesh), mesh_shape(args.prefill_mesh)
    world = max(math.prod(decode or (1,)), math.prod(prefill or (1,)))
    results = spawn_ranks(rank_main, world,
                          (_serve_body, rank_threads(world), cfg, args))
    for line in results[0]["lines"]:
        print(line)
    return dict(requests=results[0]["requests"], engine=None,
                stats=results[0]["stats"])


def _serve_body(cfg, args):
    import torch.distributed as dist
    from repro_torch.parallel.context import Mesh, ParallelCtx

    def ctx_of(spec):
        shape = mesh_shape(spec)
        if shape is None:
            return None
        mesh = Mesh.create(shape, ("data", "model"),
                           ranks=range(math.prod(shape)))
        return ParallelCtx(mesh=mesh, dp_axes=("data",),
                           moe_impl=args.moe_impl, wire=args.wire)

    ctx, prefill_ctx = ctx_of(args.mesh), ctx_of(args.prefill_mesh)
    lines = []
    res = serve(cfg, args, None, lines.append, ctx, prefill_ctx)
    if dist.get_rank() != 0:
        return None
    return dict(lines=lines, requests=res["requests"], stats=res["stats"])


if __name__ == "__main__":
    main()
