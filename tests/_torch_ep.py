"""Rank body of ``tests/test_torch_ep.py``: the port's expert-parallel MoE
(``repro_torch.parallel.ep``) on 8 gloo ranks on the CPU, on (data, model)
meshes and on (pod, data, model) meshes with the batch over the pair.

It imports torch, numpy and the port only, so a spawned rank starts
without JAX. Each rank reads the MoE layer's weights and the cases'
inputs from ``inputs.npz``, runs every case on its mesh and writes its
outputs to ``rank<r>.npz``.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

# case -> (mesh, moe_impl, wire, ep_ftp, token layout): "split" gives each
# data row its slice of the batch, "replicated" every row all of it. A
# three-axis mesh is (pod, data, model) with the batch over ("pod",
# "data"): a data row is a position of the pair
CASES = {
    "flat": ((2, 4), "ep_flat", "fp32", False, "split"),
    "dedup": ((2, 4), "ep_dedup", "fp32", False, "split"),
    "dedup_cpg2": ((1, 8), "ep_dedup", "fp32", False, "split"),
    "ftp": ((2, 4), "ep_dedup", "fp32", True, "replicated"),
    "ftp_split": ((2, 4), "ep_flat", "fp32", True, "split"),
    "fp8_wire": ((1, 4), "ep_flat", "fp8", False, "split"),
    "fp8_wire_qwen3_moe": ((1, 4), "ep_flat", "fp8", False, "split"),
    "ftp_fp8": ((2, 4), "ep_flat", "fp8", True, "replicated"),
    # the same case on the serving engine's weights: the global expert
    # stacks prepared into ``Fp8Experts`` codes (``fp8_impl="pallas"``,
    # ``bridge.prepare_for_serving``), then cut by ``shard_tree``
    "ftp_fp8_codes": ((2, 4), "ep_flat", "fp8", True, "replicated"),
    # the pair: at (2, 2, 2) smoke DeepSeek-V3's 4 groups do not divide 2
    # columns, so ep_dedup runs ep_flat there, as the reference's does;
    # (2, 1, 4) runs it (cpg = 1)
    "pod_flat": ((2, 2, 2), "ep_flat", "fp32", False, "split"),
    "pod_dedup": ((2, 2, 2), "ep_dedup", "fp32", False, "split"),
    "pod_dedup_2x1x4": ((2, 1, 4), "ep_dedup", "fp32", False, "split"),
    # ep_ftp: each pair position's tokens gathered over the pair, the
    # expert FF cut over "data" and its partials summed over "data"
    "pod_ftp": ((2, 2, 2), "ep_flat", "fp32", True, "split"),
    "pod_ftp_2x1x4": ((2, 1, 4), "ep_dedup", "fp32", True, "split"),
    # FP8 experts (expert FF 256: 128 a "data" rank) at the fp32 wire
    "pod_ftp_fp8": ((2, 2, 2), "ep_flat", "fp32", True, "split"),
    "pod_ftp_fp8_2x1x4": ((2, 1, 4), "ep_flat", "fp32", True, "split"),
    # a planted fault: the FF partials summed over the pair, as the
    # reference's ep_ftp does on a pod mesh (each counted |pod| times)
    "pod_ftp_pair_sum": ((2, 2, 2), "ep_flat", "fp32", True, "split"),
}
POD_AXES = ("pod", "data", "model")
DSV3 = "deepseek-v3-671b"
# the config of each case's MoE layer (DeepSeek-V3 smoke where not named):
# the reference's own FP8-wire case routes qwen3-moe's softmax scores;
# ``ep_ftp`` with FP8 experts runs DeepSeek-V3 smoke with its FP8 GEMMs
# and an expert FF of 256, so that the data axis cuts it into whole
# 128-blocks (128 a rank)
ARCHS = {"fp8_wire_qwen3_moe": "qwen3-moe-30b-a3b", "ftp_fp8": "dsv3-fp8",
         "ftp_fp8_codes": "dsv3-fp8", "pod_ftp_fp8": "dsv3-fp8",
         "pod_ftp_fp8_2x1x4": "dsv3-fp8"}
# a case that runs another case's input
INPUT_OF = {"ftp_fp8_codes": "ftp_fp8", "pod_ftp_pair_sum": "pod_ftp"}
# config key -> (arch, overrides of its smoke config)
CONFIGS = {"dsv3-fp8": (DSV3, dict(fp8=True, expert_ff=256))}
BYTES_SLOTS = 64


def moe_config(arch=DSV3):
    """``arch``'s smoke config without FP8 GEMMs, capacity headroom 8 (the
    reference's ``TestEP`` configs); a key of :data:`CONFIGS`: its arch's,
    with its overrides."""
    from repro_torch.configs.base import get_config, smoke_config
    arch, over = CONFIGS.get(arch, (arch, {}))
    cfg = smoke_config(get_config(arch))
    moe = dict(capacity_factor=8.0)
    if "expert_ff" in over:
        moe["expert_ff"] = over["expert_ff"]
    return dataclasses.replace(cfg, fp8=over.get("fp8", False),
                               moe=dataclasses.replace(cfg.moe, **moe))


def bench_config():
    """The port's copy of ``benchmarks.train_bench.bench_config``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    return ModelConfig(
        name="train-bench-moe", family="moe", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
        attention="gqa",
        moe=MoEConfig(num_experts=8, top_k=4, expert_ff=64, num_shared=1,
                      shared_ff=64, num_groups=4, group_limit=2, group_top=2,
                      capacity_factor=2.0, router_bias=True,
                      score_fn="sigmoid", layout="all"),
        dtype="float32", param_dtype="float32")


def _meshes():
    """Every mesh of the cases, made on every rank in one order."""
    from repro_torch.parallel.context import Mesh
    return {(2, 4): Mesh.create((2, 4)), (1, 8): Mesh.create((1, 8)),
            (1, 4): Mesh.create((1, 4), ranks=range(4)),
            (2, 2, 2): Mesh.create((2, 2, 2), POD_AXES),
            (2, 1, 4): Mesh.create((2, 1, 4), POD_AXES)}


class pair_sum:
    """``pod_ftp_pair_sum``'s fault: ``ep_ftp`` sums its FF partials over
    the batch's group (the pair) instead of ``"data"``."""

    def __enter__(self):
        from repro_torch.parallel import ep
        self.saved = ep.ftp_group
        ep.ftp_group = lambda pctx: pctx.dp_group

    def __exit__(self, *exc):
        from repro_torch.parallel import ep
        ep.ftp_group = self.saved


def run_case(name, mesh, cfg, params, x):
    import contextlib
    from repro_torch.core import moe as moe_mod
    from repro_torch.parallel import context, ep
    from repro_torch.parallel import sharding as sh
    _, impl, wire, ftp, layout = CASES[name]
    dp_axes = context.data_axes(mesh.axis_names)
    ctx = context.ParallelCtx(mesh=mesh, dp_axes=dp_axes, moe_impl=impl,
                              wire=wire, ep_ftp=ftp)
    specs = moe_mod.moe_specs(cfg, 1)
    ps = sh.param_pspecs(mesh, specs, sh.serve_rules(
        "pod" in mesh.axis_names, ep_ftp=ftp))
    qdq = bool(cfg.fp8)
    if name.endswith("_codes"):
        from repro_torch import bridge
        from repro_torch.models.param import layer
        cfg = dataclasses.replace(cfg, fp8_impl="pallas")
        prep = bridge.prepare_for_serving({"moe": params}, cfg)
        kinds = bridge.expert_storage(prep)
        assert kinds["plain"] == 0 and kinds["e4m3"] > 0, kinds
        part = sh.shard_tree(prep["moe"], ps, mesh)
        p = layer(part, 0)
    elif qdq:
        # FP8 weights are block-quantized whole, then cut (as the engine
        # prepares them at load): a model-axis cut of the shared expert
        # falls inside its 128-blocks
        from repro_torch.core.moe import ste_qdq_block
        params = {k: (v if k in ("w_gate", "bias") else ste_qdq_block(v))
                  for k, v in params.items()}
        p = {k: v[0] for k, v in sh.shard_tree(params, ps, mesh).items()}
    else:
        p = {k: v[0] for k, v in sh.shard_tree(params, ps, mesh).items()}
    dp, d = ctx.dp_size, ctx.dp_index
    split = layout == "split" and dp > 1
    if split:
        per = x.shape[0] // dp
        x = x[d * per:(d + 1) * per]
    fault = pair_sum() if name.endswith("pair_sum") else \
        contextlib.nullcontext()
    with context.use(ctx), fault:
        y, _, _ = ep.moe_ffn_sharded(p, x, cfg, ctx, replicated=not split,
                                     weights_qdq=qdq)
    return y


def bytes_case(mesh):
    """``decode_alltoall_bytes()`` of engines on ``bench_config`` at 64
    slots, and the all-to-all bytes one decode step of each really moves,
    per MoE layer."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import context
    from repro_torch.serve.engine import ServeEngine
    cfg = bench_config()
    out = {}
    for impl in ("ep_flat", "ep_dedup"):
        ctx = context.ParallelCtx(mesh=mesh, moe_impl=impl, wire="fp8")
        eng = ServeEngine(cfg, slots=BYTES_SLOTS, max_len=32, chunk=8,
                          ctx=ctx, device="cpu")
        B = BYTES_SLOTS // ctx.dp_size
        zeros = torch.zeros((B, 1), dtype=torch.int32)
        before = coll.BYTES["all_to_all"]
        eng.model.decode_step(eng.params, eng.cache, zeros, zeros, pctx=ctx,
                              batch_sharded=True)
        moved = (coll.BYTES["all_to_all"] - before) // cfg.num_layers
        out[impl] = np.array([eng.decode_alltoall_bytes(), moved])
    return out


def run_rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    meshes = _meshes()
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    out = {}
    for name, (shape, *_rest) in CASES.items():
        mesh = meshes[shape]
        if mesh.rank is None:
            continue
        arch = ARCHS.get(name, DSV3)
        params = {k.split(":")[2]: torch.from_numpy(inputs[k])
                  for k in inputs.files if k.startswith(f"p:{arch}:")}
        y = run_case(name, mesh, moe_config(arch), params,
                     torch.from_numpy(inputs["x:" + INPUT_OF.get(name,
                                                                 name)]))
        out[name] = y.numpy()
    for impl, v in bytes_case(meshes[(2, 4)]).items():
        out["bytes:" + impl] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
