"""Rank body of ``tests/test_torch_serve_mesh.py``: the port's
``ServeEngine(ctx=...)`` on 8 gloo ranks on the CPU, mesh (2, 4), and the
(pod, data, model) mesh (2, 2, 2) with the batch over the pair ("pod",
"data") for the scenarios of ``POD``.

It imports torch, numpy and the port only, so a spawned rank starts
without JAX. Each rank reads the weights (bridged from the JAX init) from
``weights.npz``, serves every scenario in turn (a single-device one on
rank 0 alone) and writes, per scenario,
its streams, its MTP counters, a CRC of its host mirrors and streams, and
a CRC of each pool leaf to ``rank<r>.npz``; for an EP scenario, the
all-to-alls of one more decode chunk under ``collectives.record()`` (count
and bytes a MoE layer and step, and whether half B's attention came
between half A's dispatch issue and its wait). The cross-mesh
disaggregation scenarios (``DISAGG``) prefill on mesh (2, 4) over every
rank and decode on mesh (1, 4) over ranks 0-3.

The scenarios with a ``drive`` key run one of the scheduler workloads
below instead of :func:`serve`'s five prompts: ``shared`` (chunked
prefill of three prompts behind one 16-token prefix), ``preempt`` (a
priority-5 arrival preempting a resident), ``tier`` and ``tier_crc``
(``tests/test_torch_tier.py``'s oversubscribed bench and its CRC
corruption, the byte flipped on rank :data:`CRC_RANK` alone). Their
functions take the engine and request classes, so the JAX single-device
engine runs the same workloads in the test module. ``fault`` plants one
fault in a run (:func:`plant`), which the test must see fail: a tier
fetch that installs the whole payload's first model column on every rank
instead of this rank's cut, and a prefill chunk that writes the next
column's K/V heads into this rank's pool.
"""
import dataclasses
import json
import os
import zlib

import numpy as np
import torch
import torch.distributed as dist

MESH = (2, 4)
# scenario -> (model, ctx kwargs or None for one device, engine kwargs)
PAGED_BF16 = dict(paged=True, page_size=8, page_storage="bf16")
CARD = dict(paged=True, page_size=8, page_storage="fp8", attn_impl="pallas")
CHUNKED = dict(PAGED_BF16, prefill_chunk=8)
SCENARIOS = {
    "gqa_dense": ("qwen", {}, {}),
    "gqa_paged": ("qwen", {}, PAGED_BF16),
    "gqa_paged_fp8": ("qwen", {}, dict(PAGED_BF16, page_storage="fp8")),
    "ep_flat": ("moe", dict(moe_impl="ep_flat", wire="fp32"), {}),
    "ep_dedup": ("moe", dict(moe_impl="ep_dedup", wire="fp32"), {}),
    "fp8_wire": ("moe", dict(moe_impl="ep_flat", wire="fp8"), {}),
    "mtp": ("moe", dict(moe_impl="ep_flat", wire="fp32"),
            dict(use_mtp=True)),
    "mla_paged": ("moe", dict(moe_impl="ep_flat", wire="fp32"), PAGED_BF16),
    "card_path": ("moe_pallas", dict(moe_impl="ep_flat", wire="fp8"), CARD),
    "card_path_single": ("moe_pallas", None, CARD),
    "ep_flat_overlap": ("moe", dict(moe_impl="ep_flat", wire="fp32"),
                        dict(decode_overlap=True)),
    "ep_dedup_overlap": ("moe", dict(moe_impl="ep_dedup", wire="fp32"),
                         dict(decode_overlap=True)),
    "disagg_dense": ("moe", dict(moe_impl="ep_flat", wire="fp32"),
                     dict(disagg=True)),
    "disagg_paged": ("moe", dict(moe_impl="ep_flat", wire="fp32"),
                     dict(PAGED_BF16, disagg=True)),
    # smoke qwen3-14b's 4 KV heads split over the model axis: the payload
    # is gathered whole on the prefill mesh and cut for the decode mesh
    "disagg_gqa": ("qwen", {}, dict(disagg=True)),
    # 6 query and 2 KV heads do not split over 4 model columns: the
    # attention runs replicated (``sharding.whole_heads``), dense ring
    # and paged
    "gqa_heads_whole": ("qwen_heads6", {}, {}),
    "gqa_heads_whole_paged": ("qwen_heads6", {}, PAGED_BF16),
    # on POD_MESH: qwen3-14b dense; DeepSeek-V3 paged fp8 on the kernel
    # path's plain versions with ep_flat; DeepSeek-V3 dense with ep_ftp
    # (FP8 GEMMs off: smoke's expert FF of 64 cuts to 32 a "data" rank,
    # inside a 128-block)
    "pod_gqa_dense": ("qwen", {}, {}),
    "pod_card_path": ("moe_pallas", dict(moe_impl="ep_flat", wire="fp8"),
                      CARD),
    "pod_ftp": ("moe_nofp8", dict(moe_impl="ep_flat", wire="fp32",
                                  ep_ftp=True), {}),
    # chunked prefill and the host page tier under the mesh
    "gqa_chunked": ("qwen", {}, dict(CHUNKED, drive="shared")),
    "gqa_chunked_fp8": ("qwen", {}, dict(CHUNKED, page_storage="fp8",
                                         drive="shared")),
    "gqa_chunked_preempt": ("qwen", {}, dict(CHUNKED, drive="preempt")),
    "mla_chunked": ("moe", dict(moe_impl="ep_flat", wire="fp32"),
                    dict(CHUNKED, drive="shared")),
    "card_path_chunked": ("moe_pallas", dict(moe_impl="ep_flat",
                                             wire="fp8"),
                          dict(CARD, prefill_chunk=8, drive="shared")),
    "card_path_chunked_single": ("moe_pallas", None,
                                 dict(CARD, prefill_chunk=8, drive="shared")),
    "gqa_tier": ("qwen", {}, dict(CHUNKED, drive="tier")),
    "gqa_tier_crc": ("qwen", {}, dict(CHUNKED, drive="tier_crc")),
    "pod_gqa_tier": ("qwen", {}, dict(CHUNKED, drive="tier")),
    "fault_tier_cut": ("qwen", {}, dict(CHUNKED, drive="tier",
                                        fault="tier_cut", requests=3)),
    "fault_chunk_cut": ("qwen", {}, dict(CHUNKED, drive="shared",
                                         fault="chunk_cut")),
}
POD = [n for n in SCENARIOS if n.startswith("pod_")]
POD_MESH = (2, 2, 2)
POD_AXES = ("pod", "data", "model")
# smoke qwen3-14b with heads that do not divide the model axis
HEADS6 = dict(num_heads=6, num_kv_heads=2)
# cross-mesh disaggregation: decode on this mesh over the first ranks
DISAGG = [n for n, (_, _, e) in SCENARIOS.items() if e.get("disagg")]
DECODE_MESH = (1, 4)
DISAGG_SLOTS = 3
# the one rank whose host copy ``tier_crc`` corrupts
CRC_RANK = 5
# the scenarios with a planted fault (each must part from the streams of
# its sound twin, ``gqa_tier`` or ``gqa_chunked``)
FAULTS = ("fault_tier_cut", "fault_chunk_cut")


def configs():
    from repro_torch.configs.base import get_config, smoke_config
    moe = smoke_config(get_config("deepseek-v3-671b"))
    moe = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, capacity_factor=8.0))
    qwen = smoke_config(get_config("qwen3-14b"))
    return {"qwen": qwen, "moe": moe,
            "moe_pallas": dataclasses.replace(moe, fp8_impl="pallas"),
            "moe_nofp8": dataclasses.replace(moe, fp8=False),
            "qwen_heads6": dataclasses.replace(qwen, **HEADS6)}


def prompts_for(vocab, n=5):
    return [np.arange(4 + i * 3) * (i + 3) % vocab for i in range(n)]


def unflatten(arrays, prefix):
    out = {}
    for k in arrays.files:
        if not k.startswith(prefix):
            continue
        node = out
        *path, leaf = k[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(arrays[k])
    return out


def _crc(*arrays) -> int:
    c = 0
    for a in arrays:
        c = zlib.crc32(np.ascontiguousarray(a).tobytes(), c)
    return c


def _pool_crcs(eng):
    """A CRC of each pool leaf of this rank."""
    return np.array(
        [_crc(t.contiguous().reshape(-1).view(torch.uint8).numpy())
         for seg in eng.model.segments
         for t in eng.cache[seg.name].values()], np.int64)


def serve(cfg, params, ctx, engine_kw):
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params=params, slots=4, max_len=32, seed=0,
                      chunk=4, ctx=ctx, device="cpu", **engine_kw)
    reqs = [Request(i, p, max_new=6)
            for i, p in enumerate(prompts_for(cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert eng.trace_counts["decode"] == 0          # eager under a mesh
    if eng.paged:
        assert eng.free_pages() == eng.pool_pages   # no page leaked
    return eng, [list(r.out) for r in reqs]


def drive_kw(drive, tier_mod):
    """The engine sizing of a scheduler workload (``tier_mod``: the
    package's ``serve.tier``): ``shared`` on :func:`serve`'s engine;
    ``preempt`` two slots over a pool that one 16 + 24 request fills;
    ``tier`` and ``tier_crc`` ``tests/test_torch_tier.py``'s bench (two
    slots, a 16-page pool holding two whole requests, a host tier three
    times that, quantum 4). Every one pages bf16 (or fp8) with chunks of
    8 (:data:`CHUNKED`)."""
    if drive == "shared":
        return dict(slots=4, max_len=32)
    if drive == "preempt":
        return dict(slots=2, max_len=64, pool_pages=5)
    return dict(slots=2, max_len=64, pool_pages=16, host_tier_pages=48,
                tier_config=tier_mod.TierConfig(quantum=4))


def shared_prompts(vocab):
    """Three prompts behind one 16-token prefix (two full pages)."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, vocab, 16)
    return [np.concatenate([prefix, rng.integers(1, vocab, 3 + 2 * i)])
            for i in range(3)]


def drive(eng, Request, name, vocab, flip=None, requests=10):
    """Run workload ``name`` on ``eng`` (either package's engine); returns
    the requests. ``flip(payload)`` corrupts a host-tier copy (``tier_crc``:
    the first entry parked in the tier)."""
    if name == "shared":
        reqs = [Request(i, p, max_new=6)
                for i, p in enumerate(shared_prompts(vocab))]
        for r in reqs:
            eng.submit(r)
            eng.step()     # two ticks: the prefix pages index before the
            eng.step()     # next admission probes them
    elif name == "preempt":
        rng = np.random.default_rng(5)
        low = Request(0, rng.integers(1, vocab, 16), max_new=24)
        high = Request(1, rng.integers(1, vocab, 12), max_new=8,
                       priority=5)
        reqs = [low, high]
        eng.submit(low)
        for _ in range(4):
            eng.step()
        eng.submit(high)
        eng.step()
        assert eng.stats["evictions"] >= 1
    else:
        rng = np.random.default_rng(7)
        reqs = [Request(rid, rng.integers(1, 500, size=9 + rid)
                        .astype(np.int32), max_new=24, seed=rid)
                for rid in range(requests)]
        for r in reqs:
            eng.submit(r)
        flipped = name != "tier_crc"
        while not flipped and eng.has_work():
            eng.step()
            for e in eng._suspended.values():
                if e["state"] == "host":
                    if flip is not None:
                        flip(eng.tier._entries[e["eid"]].payload)
                    flipped = True
                    break
        assert flipped
    eng.run_until_done()
    return reqs


# the parts of a summary the tier runs hold equal to the reference's
SUMMARY = ("streams", "done", "tier", "pool", "prefix", "stats", "free")


def _plain(d):
    return {k: float(v) if isinstance(v, (float, np.floating)) else int(v)
            for k, v in d.items()}


def summary(eng, reqs):
    """A drained run as plain Python: streams, and every figure the
    reference's tier tests compare (``stats`` but ``dispatches``)."""
    stats = {k: v for k, v in eng.stats.items() if k != "dispatches"}
    return dict(streams=[[int(t) for t in r.out] for r in reqs],
                done=[bool(r.done) for r in reqs],
                tier=_plain(eng.tier_stats()), pool=_plain(eng.pool_stats()),
                prefix=_plain(eng.prefix_stats()), stats=_plain(stats),
                free=int(eng.free_pages()))


def plant(eng, fault, ctx):
    """Plant ``fault`` in a meshed engine's run; returns the undo.
    ``chunk_cut`` is ``chip_smoke.py``'s ``chunk_heads_shifted``."""
    if fault == "tier_cut":
        install = eng.model.install_pages

        def first_column(cache, pages, ids):
            # the whole payload's leading cut on every rank: model column
            # 0's KV heads where this rank holds its own
            whole = eng.whole_payload({"pages": pages, "aux": {}})["pages"]

            def cut(w, mine):
                if isinstance(w, dict):
                    return {k: cut(w[k], mine[k]) for k in w}
                return w[tuple(slice(0, n) for n in mine.shape)]
            return install(cache, cut(whole, pages), ids)

        eng.model.install_pages = first_column
        return lambda: None
    import chip_smoke
    planted = chip_smoke.chunk_fault(ctx, "chunk_heads_shifted")
    planted.__enter__()
    return lambda: planted.__exit__(None, None, None)


def serve_drive(cfg, params, ctx, engine_kw, rank):
    """A scheduler workload (``engine_kw["drive"]``) on the port's engine:
    the engine, the summary; under the mesh the prefill chunk ran eagerly
    and no page leaked."""
    from repro_torch.serve import tier
    from repro_torch.serve.engine import Request, ServeEngine
    kw = dict(engine_kw)
    name, fault = kw.pop("drive"), kw.pop("fault", None)
    n = kw.pop("requests", 10)
    kw.update(drive_kw(name, tier))
    eng = ServeEngine(cfg, params=params, seed=0, chunk=4, ctx=ctx,
                      device="cpu", **kw)
    undo = plant(eng, fault, ctx) if fault else None

    def flip(payload):
        if rank == CRC_RANK or ctx is None:
            from repro_torch.core import paged
            paged.payload_leaves(payload)[0].view(torch.uint8).reshape(
                -1).numpy()[0] ^= 0xFF

    try:
        reqs = drive(eng, Request, name, cfg.vocab_size, flip, n)
    finally:
        if undo is not None:
            undo()
    assert all(r.done for r in reqs)
    assert eng.trace_counts == {"decode": 0, "chunk": 0}
    assert eng.free_pages() == eng.pool_pages
    return eng, summary(eng, reqs)


def aux_round_trip(eng):
    """The tier's aux path on a served engine whose slots the data axes
    cut: every rank's rows of every slot-resident leaf are set to their
    global slot number, then each slot's aux (``_slot_aux``, gathered
    from the data row that owns it) must read its number on every rank,
    and slot 0's aux installed into the last slot (``_install_slot``)
    must land in that slot's owner's rows alone. Returns whether all
    held here."""
    axes, rows = eng._axes, eng._rows

    def fill(cache, ax):
        if isinstance(ax, dict):
            for k in ax:
                fill(cache[k], ax[k])
            return
        for j in range(rows.stop - rows.start):
            cache.select(ax, j).fill_(rows.start + j)

    def reads(tree, value):
        if isinstance(tree, dict):
            return all(reads(v, value) for v in tree.values())
        return bool((tree == value).all())

    fill(eng.cache, axes)
    ok = all(reads(eng._slot_aux(s), s) for s in range(eng.slots))
    last = eng.slots - 1
    eng._install_slot(last, [], eng._slot_aux(0))
    local = eng._local_slot(last)
    for j in range(rows.stop - rows.start):
        want = 0 if j == local else rows.start + j
        ok &= reads({k: _row(eng.cache[k], axes[k], j) for k in axes}, want)
    return ok


def _row(cache, ax, j):
    if isinstance(ax, dict):
        return {k: _row(cache[k], ax[k], j) for k in ax}
    return cache.select(ax, j)


def a2a_record(eng):
    """One more decode chunk of a served EP engine under
    ``collectives.record()``: the all-to-alls a MoE layer and step, their
    bytes, and whether, in every MoE layer, half B's attention mark falls
    between half A's first all-to-all issue (its dispatch) and its wait
    (1 without overlap)."""
    from repro_torch.parallel import collectives as coll
    moe = [f"{seg.name}/{i}" for seg in eng.model.segments
           if seg.kind == "moe" for i in range(seg.n)]
    with coll.record() as rec:
        eng._run_decode(eng._host_state())
    a2a = rec.collectives("all_to_all")
    per = eng.chunk * len(moe)
    ordered = all(
        rec.position("issue", kind="all_to_all", layer=name, half="A")
        < rec.position("mark", kind="attention", layer=name, half="B")
        < rec.position("wait", kind="all_to_all", layer=name, half="A")
        for name in moe) if eng.decode_overlap else True
    return np.array([len(a2a) / per, sum(e.nbytes for e in a2a) / per,
                     float(ordered)])


def serve_disagg(cfg, params, meshes, ctx_kw, engine_kw):
    """Cross-mesh disaggregation: prefill on ``meshes[0]``, decode on
    ``meshes[1]``. Returns (streams, handoff bytes, cross_mesh); a rank
    outside the decode mesh prefills only and has no stream."""
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.disagg import Disaggregator
    from repro_torch.serve.engine import Request
    kw = {k: v for k, v in engine_kw.items() if k != "disagg"}
    dis = Disaggregator(cfg, params=params, decode_slots=DISAGG_SLOTS,
                        max_len=32, chunk=4, device="cpu",
                        prefill_ctx=ParallelCtx(mesh=meshes[0], **ctx_kw),
                        ctx=ParallelCtx(mesh=meshes[1], **ctx_kw), **kw)
    reqs = [Request(i, p, max_new=6)
            for i, p in enumerate(prompts_for(cfg.vocab_size))]
    for r in reqs:
        dis.submit(r)
    dis.run()
    if dis.decode is not None:
        assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs], dis.handoff_bytes, dis.cross_mesh


def run_rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    from repro_torch.parallel.context import Mesh, ParallelCtx, data_axes
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = Mesh.create(MESH)
    decode_mesh = Mesh.create(DECODE_MESH,
                              ranks=range(DECODE_MESH[0] * DECODE_MESH[1]))
    pod_mesh = Mesh.create(POD_MESH, POD_AXES)
    weights = np.load(os.path.join(out_dir, "weights.npz"))
    cfgs = configs()
    params = {k: unflatten(weights, k + "/")
              for k in ("qwen", "moe", "qwen_heads6")}
    params["moe_pallas"] = params["moe_nofp8"] = params["moe"]
    out = {}
    for name, (model, ctx_kw, engine_kw) in SCENARIOS.items():
        if ctx_kw is None and rank:
            continue       # a single-device scenario: rank 0 serves it
        if name in DISAGG:
            streams, nbytes, cross = serve_disagg(
                cfgs[model], params[model], (mesh, decode_mesh), ctx_kw,
                engine_kw)
            L = max(1, max(len(s) for s in streams))
            out[name] = np.array([s + [-1] * (L - len(s)) for s in streams])
            out[name + ":handoff"] = np.array([nbytes, int(cross)])
            continue
        m = pod_mesh if name in POD else mesh
        ctx = None if ctx_kw is None else ParallelCtx(
            mesh=m, dp_axes=data_axes(m.axis_names), **ctx_kw)
        if "drive" in engine_kw:
            eng, summ = serve_drive(cfgs[model], params[model], ctx,
                                    engine_kw, rank)
            text = json.dumps(summ, sort_keys=True)
            out[name + ":summary"] = np.array(text)
            streams = summ["streams"]
            L = max(len(s) for s in streams)
            out[name] = np.array([s + [-1] * (L - len(s)) for s in streams])
            out[name + ":mirrors"] = np.array([_crc(
                eng.positions, eng._tokens, eng._left, eng._tix, out[name],
                np.frombuffer(text.encode(), np.uint8))], np.int64)
            out[name + ":pool"] = _pool_crcs(eng)
            continue
        eng, streams = serve(cfgs[model], params[model], ctx, engine_kw)
        L = max(len(s) for s in streams)
        out[name] = np.array([s + [-1] * (L - len(s)) for s in streams])
        out[name + ":mtp"] = np.array([eng.stats["drafts"],
                                       eng.stats["accepted_drafts"]])
        out[name + ":mirrors"] = np.array([_crc(
            eng.positions, eng._tokens, eng._left, eng._tix,
            out[name])], np.int64)
        if eng.paged:
            out[name + ":pool"] = _pool_crcs(eng)
        if ctx is not None:
            out[name + ":a2a"] = np.array([eng.decode_alltoall_bytes()])
            if ctx.ep_enabled:
                out[name + ":record"] = a2a_record(eng)
        if name == "pod_card_path":
            out[name + ":aux"] = np.array([aux_round_trip(eng)])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
