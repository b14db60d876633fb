"""PyTorch port: the dry run (``repro_torch.launch.dryrun``) and the
roofline (``repro_torch.launch.roofline``) against the JAX reference.

The port traces one rank's step of a cell on ``meta`` tensors inside a
fake world of the mesh's size (``dryrun.fake_world``); the reference
lowers and compiles it on forced XLA host devices. Here:

* (a) ``analyze`` and ``to_markdown`` of the port's roofline against the
  reference's on the port's own records of smoke cells (qwen3-14b smoke at
  small train, prefill and decode shapes on the production mesh), the
  reference module's ``PEAK_FLOPS``/``HBM_BW``/``ICI_BW`` set to the
  port's H100 constants: every number within 1e-12 relative, the same
  markdown.
* (b) ``memory_analysis.argument_size_in_bytes`` of the port's records
  against the reference's own ``run_cell`` in one JAX subprocess on 8 host
  devices (its ``make_production_mesh`` patched to (2, 4), ``get_config``
  to the smoke configs and ``SHAPES`` to small shapes; nothing of
  ``src/repro`` edited): smoke qwen3-14b train, prefill and decode, smoke
  DeepSeek-V3 decode (``fp8`` off in both: at (2, 4) its smoke expert FF
  of 64 cuts to 32 a data rank, which the port's FP8 ``ep_ftp`` refuses),
  smoke mamba2-2.7b and llama4-maverick decode, and smoke DeepSeek-V3
  decode with E4M3 expert storage (``--expert-dtype``, which turns
  ``fp8`` off in both). Equal but for the port's
  dense-ring layout (``sharding.explicit_cache_pspecs``: the ring's length
  axis whole on each model column, the MLA latent ring and ``pos``
  replicated over it, ROADMAP.md §A item 4 (i)) and its recurrent conv
  tails (cut with their state where the reference replicates them, item
  4 (v)), whose bytes the test computes from the two placements,
  and for the arguments the reference's executable drops because its step
  never reads them (``jax.jit``'s ``keep_unused=False``: DeepSeek-V3's MTP
  weights and carried ``mtp_h`` in a decode step, Mamba-2's positions in
  one), which the port's record counts.
* (c) The sweep's statuses on every config cut in depth at its published
  widths (small shapes of the same names): ok for every family, the
  recurrent ones at ``long_500k`` too, ``long_500k`` skipped for full
  attention; the same table for every ``--multi-pod`` cell (2 x 16 x 16,
  the batch and ZeRO-3 over ``("pod", "data")``, its small shapes at 32
  rows, one a pair position); an ``--expert-dtype`` cell ok, which the
  roofline reads. And one
  cell at full depth and the real shape: DeepSeek-V3 ``decode_32k`` on
  256 fake ranks.
* (d) ``remat="full"`` lowers ``temp_size_in_bytes`` of a train cell and
  raises ``flops_per_device`` by the recomputed forward of its layer
  steps, no more.
* (e) No default process group is left after ``run_cell``, after an ok
  cell (one with ``--expert-dtype`` too) and after an error cell (a cache
  dtype the port has no storage for).
* (f) The meshed ``Model.prefill`` and ``decode_step`` of each family with
  a new meshed layout run on (1, 2) in a fake world, on ``meta``.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import mesh as mesh_mod

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")

# small shapes of the smoke cells (name -> (seq, batch, phase))
SMALL = {"train_s": (32, 8, "train"), "prefill_s": (32, 4, "prefill"),
         "decode_s": (32, 8, "decode")}
# (arch, shape, run_cell keywords) of (b)
ARG_CELLS = [("qwen3-14b", "train_s", {}), ("qwen3-14b", "prefill_s", {}),
             ("qwen3-14b", "decode_s", {}),
             ("deepseek-v3-671b", "decode_s", {"fp8": False}),
             ("mamba2-2.7b", "decode_s", {}),
             ("llama4-maverick-400b-a17b", "decode_s", {}),
             ("deepseek-v3-671b", "decode_s",
              {"expert_dtype": "float8_e4m3fn"})]

JAX_CELLS = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()
from repro.compat import make_mesh
from repro.configs import base as rb
from repro.launch import dryrun as rd
rd.make_production_mesh = lambda multi_pod=False: make_mesh(
    (2, 4), ("data", "model"))
rd.get_config = lambda a: rb.smoke_config(rb.get_config(a))
rd.SHAPES = {{k: rb.ShapeCfg(k, *v) for k, v in {small}.items()}}
out = {{}}
for arch, shape, kw in {cells}:
    rec = rd.run_cell(arch, shape, multi_pod=False, out_dir="", **kw)
    out[arch + "|" + shape + "|" + kw.get("expert_dtype", "")] = [
                               rec["status"], rec.get("error", ""),
                               rec.get("memory_analysis", {{}})]
print("CELLS", json.dumps(out))
"""

# the default single-pod sweep's statuses (ROADMAP.md, "the dry run")
OK3 = ["ok", "ok", "ok", "skipped"]
TABLE = {
    "deepseek-v3-671b": OK3, "qwen3-14b": OK3, "glm4-9b": OK3,
    "qwen1.5-4b": OK3, "yi-34b": OK3, "qwen3-moe-30b-a3b": OK3,
    "llama4-maverick-400b-a17b": OK3,
    "mamba2-2.7b": ["ok"] * 4, "recurrentgemma-9b": ["ok"] * 4,
    "seamless-m4t-large-v2": OK3, "llama-3.2-vision-90b": OK3,
}
SWEEP_SHAPES = {"train_4k": (256, 16, "train"),
                "prefill_32k": (256, 16, "prefill"),
                "decode_32k": (256, 16, "decode"),
                "long_500k": (512, 16, "decode")}
# the multi-pod sweep's: a row for each of the pair's 32 positions
POD_SHAPES = {k: (seq, 32, phase) for k, (seq, _, phase) in
              SWEEP_SHAPES.items()}


# the production meshes, before a test patches them
_PRODUCTION = mesh_mod.production_shape


def _status(rec):
    if rec["status"] == "error":
        got = re.findall(r"A\.\d+", rec["error"])
        return got[0] if got else rec["error"]
    return rec["status"]


def _depth_cut(cfg):
    """``cfg`` at its published widths with the fewest layers its layout
    allows."""
    if cfg.family == "moe" and cfg.moe.layout.startswith("dense_first:"):
        n = int(cfg.moe.layout.split(":")[1]) + 1
    elif cfg.family == "moe" and cfg.moe.layout.startswith("interleave:"):
        n = 2
    elif cfg.family == "vlm":
        n = cfg.cross_attn_every
    elif cfg.family == "hybrid":
        n = len(cfg.rglru.pattern)
    else:
        n = 1
    return dataclasses.replace(cfg, num_layers=n)


def _shapes(table):
    return {k: tbase.ShapeCfg(k, *v) for k, v in table.items()}


@pytest.fixture
def smoke_cells(monkeypatch):
    """The port's dry run on smoke configs at the small shapes; the mesh
    (2, 4) unless a test sets ``production_shape`` itself."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: tbase.smoke_config(
        tbase.get_config(a)))
    monkeypatch.setattr(dryrun, "SHAPES", _shapes(SMALL))
    monkeypatch.setattr(mesh_mod, "production_shape",
                        lambda multi_pod=False: ((2, 4), ("data", "model")))
    return monkeypatch


@pytest.fixture(scope="module")
def jax_cells():
    """The reference's records of ARG_CELLS, from one JAX subprocess on 8
    host devices."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, ROOT,
                                         env.get("PYTHONPATH", "")])
    env.pop("JAX_PLATFORMS", None)
    code = textwrap.dedent(JAX_CELLS.format(small=repr(SMALL),
                                            cells=repr(ARG_CELLS)))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()


def _cell_key(arch, shape, kw):
    return arch + "|" + shape + "|" + kw.get("expert_dtype", "")


def _layout_bytes(arch, shape, expert_dtype=""):
    """The bytes a rank holds more in the port's placement than in the
    reference's, for one smoke cell at (2, 4): the parameters (the port
    keeps heads whole, ``sharding.whole_heads``; under the decode rules
    ``serve_param_pspecs``) and, for decode, the dense cache
    (``explicit_cache_pspecs`` against the reference's
    ``cache_pspecs``)."""
    from repro_torch.models.api import Model
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.context import Mesh, ParallelCtx
    from repro_torch.serve.engine import serve_param_pspecs
    from repro_torch.train.optimizer import tree_items
    cfg = tbase.smoke_config(tbase.get_config(arch))
    if expert_dtype:
        cfg = dataclasses.replace(cfg, expert_dtype=expert_dtype, fp8=False)
    seq, batch, phase = SMALL[shape]
    mesh = Mesh.abstract((2, 4))
    model = Model(cfg, device="meta")
    specs = model.specs()
    ref = sh.param_pspecs(mesh, specs, sh.rules_for(cfg, phase, False))
    if phase == "decode":
        ours = serve_param_pspecs(cfg, ParallelCtx(
            mesh=mesh, moe_impl="ep_dedup" if cfg.moe else "local",
            ep_ftp=True), specs)
    else:
        ours = sh.whole_heads(cfg, mesh, specs, ref)

    def nbytes(tree, pspecs, per_elem=None):
        total = 0
        for path, t in tree_items(tree):
            shape = list(t.shape)
            for d, e in enumerate(sh.at_path(pspecs, path)):
                w = e.whole if isinstance(e, sh.Tail) else 0
                shape[d] = (shape[d] - w) // sh._mesh_size(mesh, e) + w
            total += math.prod(shape) * (per_elem or t.element_size())
        return total

    structs = model.param_structs()
    diff = nbytes(structs, ours) - nbytes(structs, ref)
    if phase == "train":        # fp32 master, bf16 m and v beside each
        diff += nbytes(structs, ours, 8) - nbytes(structs, ref, 8)
    if phase == "decode":
        cache = model.init_cache(batch, seq, device="meta")
        cps = sh.explicit_cache_pspecs(cache, mesh, ("data",))
        diff += (nbytes(cache, cps)
                 - nbytes(cache, sh.cache_pspecs(cache, mesh, ("data",))))
        if cfg.family == "ssm":
            # jax.jit drops the arguments a step never reads: a Mamba-2
            # decode step reads no positions ((B, 1) int32, B over data)
            diff += batch // mesh.shape["data"] * 4
        if cfg.mtp:
            # jax.jit drops the arguments a step never reads
            # (``keep_unused=False``): a decode step reads neither the MTP
            # module's weights nor the carried ``mtp_h`` (it replaces it)
            diff += (nbytes(structs["mtp"], ours["mtp"])
                     + nbytes({"h": cache["mtp_h"]}, {"h": cps["mtp_h"]}))
    return diff


def test_argument_bytes_equal_the_references(smoke_cells, jax_cells):
    ours = {}
    for arch, shape, kw in ARG_CELLS:
        rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir="", **kw)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["mesh"] == "2x4" and rec["devices"] == 8
        ours[_cell_key(arch, shape, kw)] = rec
    out, err = jax_cells.communicate(timeout=600)
    assert jax_cells.returncode == 0, err[-3000:]
    line = [x for x in out.splitlines() if x.startswith("CELLS ")][-1]
    ref = json.loads(line[len("CELLS "):])
    for arch, shape, kw in ARG_CELLS:
        key = _cell_key(arch, shape, kw)
        status, error, mem = ref[key]
        assert status == "ok", error
        got = ours[key]["memory_analysis"]["argument_size_in_bytes"]
        want = mem["argument_size_in_bytes"] + _layout_bytes(
            arch, shape, kw.get("expert_dtype", ""))
        assert got == want, (key, got, mem["argument_size_in_bytes"])
    # the layout differences are the dense rings' (more a rank) and the
    # recurrent conv tails' (less), and they show
    assert _layout_bytes("qwen3-14b", "train_s") == 0
    assert _layout_bytes("deepseek-v3-671b", "decode_s") > 0
    assert _layout_bytes("mamba2-2.7b", "decode_s") < 0


def test_roofline_equals_the_references(smoke_cells, monkeypatch, tmp_path):
    """(a): the port's records of smoke cells on the production mesh
    through both roofline modules, the reference's constants set to the
    port's H100 peaks."""
    from repro.configs import base as rbase
    from repro.launch import roofline as jroof
    from repro_torch.launch import costs
    monkeypatch.setattr(mesh_mod, "production_shape", _PRODUCTION)
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(jroof, name, getattr(costs, name))
    monkeypatch.setattr(roofline, "SHAPES", _shapes(SMALL))
    monkeypatch.setattr(jroof, "SHAPES", {k: rbase.ShapeCfg(k, *v)
                                          for k, v in SMALL.items()})
    for shape in SMALL:
        rec = dryrun.run_cell("qwen3-14b", shape, multi_pod=False,
                              out_dir=str(tmp_path))
        assert rec["status"] == "ok", rec.get("error")
        assert rec["mesh"] == "16x16" and rec["collectives"]["total"] > 0
    recs = roofline.load_records(str(tmp_path))
    assert len(recs) == len(SMALL)
    ours = [roofline.analyze(r) for r in recs]
    theirs = [jroof.analyze(r) for r in recs]
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, float):
                assert abs(a[k] - v) <= 1e-12 * abs(v), k
            else:
                assert a[k] == v, k
    skipped = dict(recs[0], shape="long_500k", status="skipped",
                   reason="long_500k skipped: pure full-attention arch")
    assert (roofline.to_markdown(ours + [skipped])
            == jroof.to_markdown(theirs + [skipped]))


def test_sweep_statuses(monkeypatch):
    """(c): the default sweep's table on depth-cut configs at published
    widths, the same table for the multi-pod cells, and an
    ``--expert-dtype`` cell."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: _depth_cut(tbase.get_config(a)))
    monkeypatch.setattr(dryrun, "SHAPES", _shapes(SWEEP_SHAPES))
    got = {a: [_status(dryrun.run_cell(a, s, multi_pod=False, out_dir=""))
               for s in SWEEP_SHAPES] for a in tbase.list_archs()}
    assert got == TABLE
    monkeypatch.setattr(dryrun, "SHAPES", _shapes(POD_SHAPES))
    pod = {a: [_status(dryrun.run_cell(a, s, multi_pod=True, out_dir=""))
               for s in POD_SHAPES] for a in tbase.list_archs()}
    assert pod == TABLE, pod
    monkeypatch.setattr(dryrun, "SHAPES", _shapes(SWEEP_SHAPES))
    rec = dryrun.run_cell("deepseek-v3-671b", "decode_32k", multi_pod=False,
                          out_dir="", expert_dtype="float8_e4m3fn")
    assert _status(rec) == "ok"
    plain = dryrun.run_cell("deepseek-v3-671b", "decode_32k",
                            multi_pod=False, out_dir="", fp8=False)
    # the routed experts a rank holds, 1 byte a weight where bf16 takes 2
    assert (rec["memory_analysis"]["argument_size_in_bytes"]
            < plain["memory_analysis"]["argument_size_in_bytes"])
    assert roofline.analyze(rec)["arch"] == "deepseek-v3-671b"
    assert dryrun.main(["--arch", "mamba2-2.7b", "--shape", "train_4k",
                        "--out", ""]) == 0
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k",
                        "--out", ""]) == 0


def test_deepseek_decode_at_full_depth():
    """(c): DeepSeek-V3 ``decode_32k`` whole (61 layers, 256 fake ranks):
    ok, every collective kind of its step present but the reduce-scatter,
    and the MLA latent ring of a rank the whole ring's model-column copy
    (ROADMAP.md §A item 4 (i))."""
    rec = dryrun.run_cell("deepseek-v3-671b", "decode_32k", multi_pod=False,
                          out_dir="")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 256 and rec["backend"] == "torch"
    c = rec["collectives"]
    assert c["total"] > 0 and c["all-to-all"] > 0 and c["all-reduce"] > 0
    cfg = tbase.get_config("deepseek-v3-671b")
    mla = cfg.mla
    # 8 slots a data rank, every latent row of the ring on every column
    ring = (cfg.num_layers * 8 * 32768 * (mla.kv_lora_rank + mla.qk_rope_dim)
            * torch.tensor([], dtype=getattr(torch, cfg.cache_dtype_())
                           ).element_size())
    assert rec["memory_analysis"]["argument_size_in_bytes"] > ring
    assert not dist.is_initialized()


def test_remat_full_trades_memory_for_the_recomputed_forward(monkeypatch):
    """(d): a train cell (qwen3-14b, 2 layers at published widths, 256 x 16
    tokens) under ``remat="full"`` against ``"none"``: less peak temporary
    memory; more FLOPs by exactly the layer steps' recomputed forward (a
    layer's forward is the FLOP count of the loss's forward at 2 layers
    less that at 1 layer), no more."""
    shapes = _shapes({"train_4k": SWEEP_SHAPES["train_4k"]})
    monkeypatch.setattr(dryrun, "SHAPES", shapes)

    def cell(layers, remat):
        monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.
                            replace(tbase.get_config(a), num_layers=layers))
        return dryrun.run_cell("qwen3-14b", "train_4k", multi_pod=False,
                               out_dir="", remat=remat)

    none, full = cell(2, "none"), cell(2, "full")
    assert (full["memory_analysis"]["temp_size_in_bytes"]
            < none["memory_analysis"]["temp_size_in_bytes"])
    delta = full["flops_per_device"] - none["flops_per_device"]
    layer_fwd = _loss_forward_flops(monkeypatch, 2) - _loss_forward_flops(
        monkeypatch, 1)
    # the recompute stops at the last activation the backward needs
    # (non-reentrant checkpoint's early stop): each step's last product,
    # ``w_down`` over the rank's tokens (gathered: 256 of one sequence) and
    # its 1/16 of d_ff, is not recomputed
    cfg = tbase.get_config("qwen3-14b")
    w_down = 2 * 256 * (cfg.d_ff // 16) * cfg.d_model
    assert delta == 2 * (layer_fwd - w_down), (delta, layer_fwd, w_down)


def _loss_forward_flops(monkeypatch, layers):
    """FLOPs of the train cell's ``Model.loss`` forward alone (no grad), on
    a rank of the production mesh."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.parallel import context as C
    from repro_torch.parallel import sharding as sh
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        tbase.get_config(a), num_layers=layers))
    with dryrun.fake_world(256):
        _, args, ctx, mesh, model = dryrun.build_cell(
            "qwen3-14b", "train_4k", multi_pod=False, remat="none")
        params, _, batch = args
        ps = sh.train_pspecs(mesh, model.specs(), cfg=model.cfg)
        with FlopCounterMode(display=False) as fc, torch.no_grad(), C.use(
                dataclasses.replace(ctx, zero3=sh.Zero3(mesh, ps))):
            model.loss(params, batch)
    return fc.get_total_flops()


def test_no_process_group_is_left(smoke_cells):
    """(e): the fake world is gone after a cell, ok or not, and a cell
    refuses to run inside a caller's world."""
    rec = dryrun.run_cell("qwen3-14b", "decode_s", multi_pod=False,
                          out_dir="")
    assert rec["status"] == "ok" and not dist.is_initialized()
    rec = dryrun.run_cell("deepseek-v3-671b", "decode_s", multi_pod=False,
                          out_dir="", expert_dtype="float8_e4m3fn")
    assert rec["status"] == "ok" and not dist.is_initialized()
    rec = dryrun.run_cell("qwen3-14b", "decode_s", multi_pod=False,
                          out_dir="", cache_dtype="float16")
    assert rec["status"] == "error" and "float16" in rec["error"]
    assert not dist.is_initialized()
    with dryrun.fake_world(2):
        rec = dryrun.run_cell("qwen3-14b", "decode_s", multi_pod=False,
                              out_dir="")
        assert rec["status"] == "error" and "initialized" in rec["error"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", list(SMALL))
def test_meter_flops_equal_flop_counter_mode(smoke_cells, shape):
    """The meter counts FLOPs by ``FlopCounterMode``'s own formulas: over
    one traced step of smoke DeepSeek-V3 (MLA, MoE on ``ep_dedup``, MTP)
    at (2, 4) its count equals ``FlopCounterMode``'s, train (with remat's
    recompute), prefill and decode. ``fp8`` off: at (2, 4) the smoke
    widths cut its FP8 blocks inside 128 (the train step and ``ep_ftp``
    refuse that)."""
    from torch.utils.flop_counter import FlopCounterMode
    kw = {"fp8": False}
    with dryrun.fake_world(8):
        step, args, *_ = dryrun.build_cell("deepseek-v3-671b", shape,
                                           multi_pod=False, **kw)
        with FlopCounterMode(display=False) as fc:
            step(*args)
        step, args, *_ = dryrun.build_cell("deepseek-v3-671b", shape,
                                           multi_pod=False, **kw)
        got = dryrun.measure(step, args)["flops_per_device"]
    assert got == fc.get_total_flops() > 0


def test_meshed_model_entry_points_take_the_gate():
    """(f): a meshed call of ``Model.prefill`` or ``decode_step`` runs for
    every family whose meshed layout this port added (the recurrent
    families, the enc-dec family with its frames, the dense/MoE pairs):
    each rank's step of the dry run's build on (1, 2) in a fake world, on
    ``meta``, gives logits of the whole vocabulary."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.parallel.context import Mesh
    for arch in ("mamba2-2.7b", "recurrentgemma-9b",
                 "seamless-m4t-large-v2", "llama4-maverick-400b-a17b"):
        cfg = tbase.smoke_config(tbase.get_config(arch))
        for phase in ("prefill", "decode"):
            with dryrun.fake_world(2):
                step, args, *_ = dryrun.build_step(
                    cfg, ShapeCfg("s", 16, 2, phase),
                    Mesh.create((1, 2)), remat="none")
                logits, cache = step(*args)
            assert tuple(logits.shape) == (2, 1, cfg.vocab_size), arch
            assert cache
