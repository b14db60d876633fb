"""Rank body of ``tests/test_torch_serve_mesh.py``: the port's
``ServeEngine(ctx=...)`` on 8 gloo ranks on the CPU, mesh (2, 4), and the
(pod, data, model) mesh (2, 2, 2) with the batch over the pair ("pod",
"data") for the scenarios of ``POD``.

It imports torch, numpy and the port only, so a spawned rank starts
without JAX. Each rank reads the weights (bridged from the JAX init) from
``weights.npz``, serves every scenario in turn and writes, per scenario,
its streams, its MTP counters, a CRC of its host mirrors and streams, and
a CRC of each pool leaf to ``rank<r>.npz``; for an EP scenario, the
all-to-alls of one more decode chunk under ``collectives.record()`` (count
and bytes a MoE layer and step, and whether half B's attention came
between half A's dispatch issue and its wait). The cross-mesh
disaggregation scenarios (``DISAGG``) prefill on mesh (2, 4) over every
rank and decode on mesh (1, 4) over ranks 0-3.
"""
import dataclasses
import os
import zlib

import numpy as np
import torch
import torch.distributed as dist

MESH = (2, 4)
# scenario -> (model, ctx kwargs or None for one device, engine kwargs)
PAGED_BF16 = dict(paged=True, page_size=8, page_storage="bf16")
CARD = dict(paged=True, page_size=8, page_storage="fp8", attn_impl="pallas")
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
        eng, streams = serve(cfgs[model], params[model], ctx, engine_kw)
        L = max(len(s) for s in streams)
        out[name] = np.array([s + [-1] * (L - len(s)) for s in streams])
        out[name + ":mtp"] = np.array([eng.stats["drafts"],
                                       eng.stats["accepted_drafts"]])
        out[name + ":mirrors"] = np.array([_crc(
            eng.positions, eng._tokens, eng._left, eng._tix,
            out[name])], np.int64)
        if eng.paged:
            out[name + ":pool"] = np.array(
                [_crc(t.contiguous().reshape(-1).view(torch.uint8).numpy())
                 for seg in eng.model.segments
                 for t in eng.cache[seg.name].values()], np.int64)
        if ctx is not None:
            out[name + ":a2a"] = np.array([eng.decode_alltoall_bytes()])
            if ctx.ep_enabled:
                out[name + ":record"] = a2a_record(eng)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
