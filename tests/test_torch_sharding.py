"""PyTorch port: ``repro_torch.parallel.sharding`` against the JAX
reference ``repro.parallel.sharding``, in process, no ranks.

Every placement the port computes equals the reference's
``PartitionSpec``, entry for entry: ``spec_to_pspec``/``param_pspecs``
under the four rule tables, ``cache_pspecs``, ``paged_cache_pspecs``,
``tier_payload_pspecs``, ``decode_state_shardings``, ``batch_pspec``,
``input_shardings`` and the placement half of ``train_state_shardings``,
for DeepSeek-V3 and qwen3-14b at published and smoke widths, on meshes
(2, 4), (1, 4) and (1, 8). The JAX side runs on an ``AbstractMesh`` (no
devices) and on shapes only (``jax.eval_shape``); the port's on an
abstract ``Mesh`` and meta tensors. The module takes about 10 s.

Also the FP8 cut rule of explicit placement: a rank's codes and block
scales are the slice of the global ``quantize_blockwise``, and a cut that
crosses a 128 block raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs.base import get_config as jget
from repro.configs.base import smoke_config as jsmoke
from repro.models.api import Model as JModel
from repro.parallel import sharding as jsh
from repro_torch.configs.base import MLAConfig
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import fp8
from repro_torch.models.api import Model
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.context import Mesh

MESHES = [(2, 4), (1, 4), (1, 8)]
# the multi-pod meshes: the batch over the pair ("pod", "data")
POD_MESHES = [(2, 2, 2), (2, 1, 4)]
POD_AXES = ("pod", "data", "model")
ARCHS = ["deepseek-v3-671b", "qwen3-14b"]
RULES = ["serve_rules", "tp_rules", "dp_ep_rules", "fsdp_tp_rules"]
MAX_LEN, PAGE, POOL = 64, 8, 32


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else POD_AXES


def _jmesh(shape):
    try:
        return AbstractMesh(shape, _axes(shape))
    except TypeError:          # older signature: ((name, size), ...)
        return AbstractMesh(tuple(zip(_axes(shape), shape)))


def _jflat(tree):
    """{path: entries} of a JAX tree of PartitionSpecs or NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP) or hasattr(x, "spec"))[0]
    out = {}
    for path, leaf in leaves:
        spec = leaf.spec if hasattr(leaf, "spec") else leaf
        out[tuple(getattr(k, "key", getattr(k, "name", k)) for k in path)] = \
            tuple(spec)
    return out


def _tflat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, path + (k,)))
        return out
    if hasattr(tree, "_fields"):             # NamedTuple (AdamWState)
        out = {}
        for k in tree._fields:
            out.update(_tflat(getattr(tree, k), path + (k,)))
        return out
    return {path: tuple(tree)}


def _same(ours, ref):
    a, b = _tflat(ours), _jflat(ref)
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    bad = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert not bad, bad
    return len(a)


def _models(arch, smoke):
    jcfg, tcfg = jget(arch), tget(arch)
    if smoke:
        jcfg, tcfg = jsmoke(jcfg), tsmoke(tcfg)
    return JModel(jcfg), Model(tcfg, device="cpu")


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_reference(arch, smoke, mesh_shape):
    jm, tm = _models(arch, smoke)
    jmesh, mesh = _jmesh(mesh_shape), Mesh.abstract(mesh_shape)
    jspecs, tspecs = jm.specs(), tm.specs()
    n = 0
    for rule in RULES:
        for pod in (False, True):
            if pod and rule != "fsdp_tp_rules":
                continue
            kw = {}
            rules_j = getattr(jsh, rule)(pod, **kw)
            rules_t = getattr(sh, rule)(pod, **kw)
            assert rules_t == rules_j
            if pod:       # a "pod" axis the meshes lack: compare tables only
                continue
            n += _same(sh.param_pspecs(mesh, tspecs, rules_t),
                       jsh.param_pspecs(jmesh, jspecs, rules_j))
    for ftp in (False, True):
        assert sh.serve_rules(False, ep_ftp=ftp) == \
            jsh.serve_rules(False, ep_ftp=ftp)
        _same(sh.param_pspecs(mesh, tspecs, sh.serve_rules(False, ftp)),
              jsh.param_pspecs(jmesh, jspecs, jsh.serve_rules(False, ftp)))
    for phase in ("train", "prefill", "decode"):
        assert sh.rules_for(None, phase, False) == \
            jsh.rules_for(None, phase, False)
    # the placement half of train_state_shardings: params, AdamW state
    pt, ot, _ = sh.train_state_shardings(mesh, tspecs, sh.fsdp_tp_rules(False))
    pj, oj, _ = jsh.train_state_shardings(jmesh, jspecs,
                                          jsh.fsdp_tp_rules(False))
    _same(pt, pj)
    for field in ("master", "m", "v"):
        _same(getattr(ot, field), getattr(oj, field))
    assert tuple(ot.step) == tuple(oj.step.spec)
    assert n > 0


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_state_pspecs_equal_reference(arch, smoke, mesh_shape):
    jm, tm = _models(arch, smoke)
    jmesh, mesh = _jmesh(mesh_shape), Mesh.abstract(mesh_shape)
    dp = ("data",)
    for batch in (8, 3):
        jdense = jax.eval_shape(lambda: jm.init_cache(batch, MAX_LEN))
        tdense = tm.init_cache(batch, MAX_LEN, device="meta")
        _same(sh.cache_pspecs(tdense, mesh, dp),
              jsh.cache_pspecs(jdense, jmesh, dp))
        jpaged = jax.eval_shape(lambda: jm.init_paged_cache(
            batch, MAX_LEN, PAGE, POOL, "fp8"))
        tpaged = tm.init_paged_cache(batch, MAX_LEN, PAGE, POOL, "fp8",
                                     device="meta")
        _same(sh.paged_cache_pspecs(tpaged, mesh, dp),
              jsh.paged_cache_pspecs(jpaged, jmesh, dp))
        jpay = jax.eval_shape(lambda c: jm.gather_pages(c, jnp.arange(3)),
                              jpaged)
        tpay = tm.gather_pages(tpaged, [0, 1, 2])
        _same(sh.tier_payload_pspecs(tpay, mesh),
              jsh.tier_payload_pspecs(jpay, jmesh))
        tstate = sh.decode_state_shardings(mesh, batch, dp)
        jstate = jsh.decode_state_shardings(jmesh, batch, dp)
        assert {k: tuple(v) for k, v in tstate.items()} == \
            {k: tuple(v.spec) for k, v in jstate.items()}
        for ndim in (1, 2, 3):
            for seq in (None, "model"):
                assert tuple(sh.batch_pspec(mesh, batch, dp, ndim, seq)) == \
                    tuple(jsh.batch_pspec(jmesh, batch, dp, ndim, seq))
        inputs_j = {"tokens": jax.ShapeDtypeStruct((batch, 16), jnp.int32),
                    "labels": jax.ShapeDtypeStruct((batch, 16), jnp.int32),
                    "cache": jdense}
        inputs_t = {"tokens": torch.empty((batch, 16), device="meta"),
                    "labels": torch.empty((batch, 16), device="meta"),
                    "cache": tdense}
        _same(sh.input_shardings(mesh, inputs_t, dp),
              jsh.input_shardings(jmesh, inputs_j, dp))


@pytest.mark.parametrize("mesh_shape", POD_MESHES)
@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pod_pspecs_equal_reference(arch, smoke, mesh_shape):
    """On (pod, data, model) meshes, with the batch over the pair: the
    parameters under the reference's multi-pod rules (ZeRO-3's ``embed``
    over ``("pod", "data")``; ``train_pspecs`` reads ``multi_pod`` off the
    mesh), the decode rules with and without ``ep_ftp`` (the expert FF
    over ``"data"`` alone), and the cache, tier, state and batch
    placements over ``("pod", "data")``."""
    jm, tm = _models(arch, smoke)
    jmesh, mesh = _jmesh(mesh_shape), Mesh.abstract(mesh_shape, POD_AXES)
    jspecs, tspecs = jm.specs(), tm.specs()
    dp = ("pod", "data")
    for rule in RULES:
        if rule == "serve_rules":
            continue
        _same(sh.param_pspecs(mesh, tspecs, getattr(sh, rule)(True)),
              jsh.param_pspecs(jmesh, jspecs, getattr(jsh, rule)(True)))
    assert _same(sh.train_pspecs(mesh, tspecs), jsh.param_pspecs(
        jmesh, jspecs, jsh.fsdp_tp_rules(True))) > 0
    for ftp in (False, True):
        _same(sh.param_pspecs(mesh, tspecs, sh.serve_rules(True, ftp)),
              jsh.param_pspecs(jmesh, jspecs, jsh.serve_rules(True, ftp)))
    for batch in (8, 3):
        jdense = jax.eval_shape(lambda: jm.init_cache(batch, MAX_LEN))
        tdense = tm.init_cache(batch, MAX_LEN, device="meta")
        _same(sh.cache_pspecs(tdense, mesh, dp),
              jsh.cache_pspecs(jdense, jmesh, dp))
        jpaged = jax.eval_shape(lambda: jm.init_paged_cache(
            batch, MAX_LEN, PAGE, POOL, "fp8"))
        tpaged = tm.init_paged_cache(batch, MAX_LEN, PAGE, POOL, "fp8",
                                     device="meta")
        _same(sh.paged_cache_pspecs(tpaged, mesh, dp),
              jsh.paged_cache_pspecs(jpaged, jmesh, dp))
        tstate = sh.decode_state_shardings(mesh, batch, dp)
        jstate = jsh.decode_state_shardings(jmesh, batch, dp)
        assert {k: tuple(v) for k, v in tstate.items()} == \
            {k: tuple(v.spec) for k, v in jstate.items()}
        for ndim in (1, 2, 3):
            assert tuple(sh.batch_pspec(mesh, batch, dp, ndim)) == \
                tuple(jsh.batch_pspec(jmesh, batch, dp, ndim))


def _fake_rank(rank, world):
    """This process as rank ``rank`` of a fake world of ``world`` (the dry
    run's backend: every collective moves nothing); destroy it after."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    dryrun._register_backend()
    dist.init_process_group(dryrun.BACKEND, store=dist.HashStore(),
                            rank=rank, world_size=world)


def test_pod_mesh_makes_each_data_plane_group():
    """``Mesh.create((2, 2, 2), ("pod", "data", "model"))`` on each of the
    8 ranks of a fake world: the rank's data plane is the group of the 4
    ranks that share its model column, in pod-major order, the same
    members as its pod and data lines span together; ``dp_index`` is
    ``pod * 2 + data``, its position in that group; a two-axis mesh makes
    no plane. ``survivor_mesh`` halves "pod" first: (1, 2, 2) over ranks
    0-3, whose planes are their data lines, and ranks 4-7 get no
    position."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import survivor_mesh
    from repro_torch.parallel.context import ParallelCtx
    for r in range(8):
        _fake_rank(r, 8)
        try:
            mesh = Mesh.create((2, 2, 2), POD_AXES)
            ctx = ParallelCtx(mesh=mesh, dp_axes=("pod", "data"))
            p, d, m = r // 4, r // 2 % 2, r % 2
            plane = dist.get_process_group_ranks(ctx.dp_group)
            assert plane == [m, 2 + m, 4 + m, 6 + m], (r, plane)
            assert ctx.dp_index == 2 * p + d == plane.index(r)
            assert ctx.dp_size == 4
            assert dist.get_process_group_ranks(mesh.groups["pod"]) == [
                2 * d + m, 4 + 2 * d + m]
            assert dist.get_process_group_ranks(mesh.groups["data"]) == [
                4 * p + m, 4 * p + 2 + m]
            assert ParallelCtx(mesh=mesh).dp_index == d    # one data axis
            assert set(Mesh.create((4, 2)).groups) == {"data", "model"}
            alive = survivor_mesh(mesh)
            assert alive.shape == {"pod": 1, "data": 2, "model": 2}
            assert alive.ranks == [0, 1, 2, 3]
            if r < 4:
                assert alive.rank == r
                g = alive.group_of(("pod", "data"))
                assert dist.get_process_group_ranks(g) == [m, 2 + m]
                assert alive.index_of(("pod", "data")) == d
            else:
                assert alive.rank is None and not alive.groups
        finally:
            dist.destroy_process_group()


def test_paged_page_table_is_replicated():
    _, tm = _models("qwen3-14b", True)
    cache = tm.init_paged_cache(4, MAX_LEN, PAGE, POOL, "bf16",
                                device="meta")
    specs = sh.paged_cache_pspecs(cache, Mesh.abstract((2, 4)), ("data",))
    assert specs["page_table"] == sh.P()
    assert specs["blocks"]["k"] == sh.P(None, None, None, "model", None)


def test_explicit_cache_placement_keeps_ring_length_whole():
    """The port's own cache layout: the reference's, but each dense ring's
    length axis whole (MLA latent replicated over model, GQA K/V over
    their KV heads)."""
    mesh = Mesh.abstract((2, 4))
    for arch, names in (("deepseek-v3-671b", ("ckv", "kr", "pos")),
                        ("qwen3-14b", ("k", "v", "pos"))):
        _, tm = _models(arch, False)
        cache = tm.init_cache(8, MAX_LEN, device="meta")
        ref = sh.cache_pspecs(cache, mesh, ("data",))
        ours = sh.explicit_cache_pspecs(cache, mesh, ("data",))
        for name in names:
            r, o = ref["blocks"][name], ours["blocks"][name]
            assert r[2] == "model" and o[2] is None and o[1] == "data"
            if name in ("k", "v"):
                assert o[3] == "model"


def _cut(w, pspec, mesh_shape, rank):
    mesh = Mesh(mesh_shape, rank=rank)
    return sh.cut_leaf(w, pspec, mesh)


@pytest.mark.parametrize("K,N,axis", [(256, 96, "col"), (256, 512, "col"),
                                      (96, 256, "row"), (512, 256, "row")])
def test_fp8_cut_is_the_slice_of_the_global_quantization(K, N, axis):
    """Column cuts of N, row cuts of K, over 4 model columns: inside one
    block (96/4, 24 a rank) or on block boundaries (512/4)."""
    g = np.random.default_rng([26, K, N])
    w = torch.from_numpy(g.standard_normal((2, K, N)).astype(np.float32))
    wq, ws = fp8.quantize_blockwise(w)
    full = fp8.Fp8Weight(w, fp8.k_major(wq), ws)
    pspec = sh.P(None, None, "model") if axis == "col" else \
        sh.P(None, "model", None)
    d = 2 if axis == "col" else 1
    for r in range(4):
        part = _cut(full, pspec, (1, 4), r)
        per = w.shape[d] // 4
        sl = [slice(None)] * 3
        sl[d] = slice(r * per, (r + 1) * per)
        assert torch.equal(part.w, w[tuple(sl)])
        assert torch.equal(part.wq.view(torch.uint8),
                           wq[tuple(sl)].view(torch.uint8))
        assert part.wq.transpose(-1, -2).is_contiguous()   # K-major
        # the scales of the blocks the slice lies in, and its dequant
        # equals the slice of the global dequant
        deq = fp8.dequant_blockwise(part.wq, part.ws)
        assert torch.equal(deq, fp8.dequant_blockwise(wq, ws)[tuple(sl)])


def test_fp8_cut_across_a_block_raises():
    w = torch.ones((1, 192, 64))
    wq, ws = fp8.quantize_blockwise(w)
    full = fp8.Fp8Weight(w, fp8.k_major(wq), ws)
    with pytest.raises(ValueError, match="crosses"):
        _cut(full, sh.P(None, "model", None), (1, 2), 1)
    assert sh.cut_blocks(512, 4, 3) == (3, 1)
    assert sh.cut_blocks(96, 4, 2) == (0, 1)
    with pytest.raises(ValueError):
        sh.cut_blocks(384, 2, 0)


def test_block_cuts_ok_at_published_widths_only():
    """Published widths cut every block-quantized weight on 128
    boundaries (the card's engine draws and prepares its slice alone);
    smoke widths cut inside one block (prepared globally, then cut)."""
    mesh = Mesh.abstract((1, 4))
    for arch in ARCHS:
        for smoke, want in ((False, True), (True, False)):
            _, tm = _models(arch, smoke)
            specs = tm.specs()
            ps = sh.param_pspecs(mesh, specs, sh.serve_rules(False))
            if arch == "qwen3-14b" and smoke:
                want = False      # heads of 32 a rank: inside one block
            assert sh.block_cuts_ok(specs, ps, mesh) == want, (arch, smoke)


def _aligned(arch):
    """``arch``'s family at small widths whose every block-quantized cut
    over 4 model columns falls on 128 boundaries, as at published widths:
    bf16, FP8 linears and E4M3 experts (``fp8_impl="pallas"``, the plain
    versions on the CPU)."""
    cfg = tsmoke(tget(arch))
    kw = dict(num_layers=2, d_model=256, num_heads=8, d_ff=512,
              vocab_size=512,
              dtype="bfloat16", param_dtype="bfloat16", fp8_impl="pallas")
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=128, q_lora_rank=128,
                              qk_nope_dim=64, qk_rope_dim=64, v_head_dim=64)
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=8,
                                        expert_ff=128, shared_ff=512)
    else:
        kw.update(num_kv_heads=4, head_dim=128)
    return dataclasses.replace(cfg, **kw)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _bits(t):
    return t.view(torch.uint8) if t.dtype == fp8.E4M3 else t


@pytest.mark.parametrize("arch,moe_impl", [
    ("deepseek-v3-671b", "ep_flat"), ("qwen3-14b", "local")])
def test_sliced_draw_equals_the_cut_of_the_global_tree(arch, moe_impl):
    """The engine's install path at published widths: each rank draws its
    slices alone and prepares them in place (``place_params(sliced=
    True)``); its codes, block scales and bf16 leaves equal, bit for bit,
    the rank's cut of the prepared global tree (the smoke widths' path,
    ``sliced=False``: ``shard_tree(prepare_for_serving(Model.init))``)."""
    from repro_torch.bridge import prepare_for_serving
    from repro_torch.core.fp8 import Fp8Experts, Fp8Weight
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.engine import place_params, serve_param_pspecs
    cfg = _aligned(arch)
    model = Model(cfg, device="cpu")
    specs = model.specs()
    whole = prepare_for_serving(model.init(3), cfg, inplace=True)
    kinds = set()
    for r in range(4):
        ctx = ParallelCtx(mesh=Mesh((1, 4), rank=r), moe_impl=moe_impl)
        pspecs = serve_param_pspecs(cfg, ctx, specs)
        assert sh.block_cuts_ok(specs, pspecs, ctx.mesh)
        a = dict(_leaves(place_params(model, ctx, None, 3, "cpu",
                                      sliced=True)))
        b = dict(_leaves(sh.shard_tree(whole, pspecs, ctx.mesh)))
        assert a.keys() == b.keys()
        for path, x in a.items():
            y = b[path]
            assert type(x) is type(y), path
            kinds.add(type(x).__name__)
            if isinstance(x, Fp8Weight):
                pairs = [(x.w, y.w), (x.wq, y.wq), (x.ws, y.ws)]
            elif isinstance(x, Fp8Experts):
                assert (x.dtype, x.d_in, x.d_out) == (y.dtype, y.d_in,
                                                      y.d_out), path
                pairs = [(x.wq, y.wq), (x.ws, y.ws)]
            elif isinstance(x, torch.Tensor):
                pairs = [(x, y)]
            else:
                assert x == y, path
                continue
            for u, v in pairs:
                assert u.dtype == v.dtype and u.shape == v.shape, path
                assert torch.equal(_bits(u), _bits(v)), path
    want = {"Tensor"} | ({"Fp8Weight"} if cfg.fp8 else set()) | (
        {"Fp8Experts"} if moe_impl == "ep_flat" else set())
    assert want <= kinds, kinds


@pytest.mark.parametrize("field,value", [
    ("remat", "full"), ("seq_axis", "model"), ("pin_attn", False)])
def test_unread_ctx_fields_raise(field, value):
    """The reference's ParallelCtx fields the port once refused (ROADMAP.md,
    A.8) are ported: ``remat`` and ``seq_axis`` are read, ``pin_attn`` is
    the GSPMD hint explicit SPMD always satisfies, and ``dp_axes`` takes
    the pair ``("pod", "data")``; each takes the reference's value. What
    is still refused raises: a value outside the reference's choices, a
    sequence cut off the tensor-parallel axis, and a data plane asked of
    an abstract mesh names why. On a pod mesh as on one pod, the serving
    placements of the dense/MoE pairs (ported, A.11) cut their experts
    over the model axis."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.api import Model
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.engine import serve_param_pspecs
    assert getattr(ParallelCtx(**{field: value}), field) == value
    bad = {"remat": "some", "seq_axis": "data", "pin_attn": None}[field]
    if field != "pin_attn":
        with pytest.raises(ValueError, match=field):
            ParallelCtx(**{field: bad})
    ctx = ParallelCtx(mesh=Mesh.abstract((2, 2, 2), ("pod", "data",
                                                     "model")),
                      dp_axes=("pod", "data"), **{field: value})
    cfg = smoke_config(get_config("llama4-maverick-400b-a17b"))
    ps = serve_param_pspecs(cfg, dataclasses.replace(ctx, moe_impl="ep_flat"),
                            Model(cfg, device="meta").specs())
    for w in ("w1", "w2", "w3"):
        assert ps["pat"]["moe"]["moe"][w][1] == "model", ps["pat"]["moe"]
    assert ctx.dp_size == 4
    with pytest.raises(ValueError, match="abstract"):
        ctx.dp_group


def test_microbatches_is_read():
    """``microbatches`` is the meshed train step's (``train/trainer.py``):
    any value is taken, and the dual step engages at 2 or more when the
    global batch splits into two halves a data rank."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.train.trainer import dual_microbatch_engaged
    cfg = smoke_config(get_config("qwen3-14b"))
    mesh = Mesh.abstract((2, 2))
    assert not dual_microbatch_engaged(
        cfg, ParallelCtx(mesh=mesh, microbatches=1), 8)
    assert dual_microbatch_engaged(cfg, ParallelCtx(mesh=mesh), 8)
    assert not dual_microbatch_engaged(cfg, ParallelCtx(mesh=mesh), 6)
    assert not dual_microbatch_engaged(cfg, ParallelCtx(), 8)
