"""PyTorch port: expert-parallel MoE (``repro_torch.parallel.ep``) against
the JAX reference.

One spawn of 8 gloo ranks on the CPU (rank body ``tests/_torch_ep.py``,
no JAX) runs every case of the reference's ``TestEP``
(``tests/test_distributed.py``) on the port's meshes; each is held
against JAX's single-device ``moe_ffn(..., capacity_override=512)``,
computed here on the same weights (the reference's tests hold its
``shard_map`` to the same oracle):

* ``ep_flat`` and ``ep_dedup`` at the fp32 wire on (2, 4), within 1e-4 of
  max|y| (at (2, 4) DeepSeek-V3 smoke's 4 groups give ``cpg = 1``);
* ``ep_dedup`` with ``cpg = 2`` (hop 2, the intra-group exchange) on
  (1, 8);
* ``ep_ftp`` on (2, 4), tokens replicated over the data axis, and with a
  data-split batch (gathered over the data axis first);
* the FP8 wire on (1, 4) within 0.05, on the reference's own case
  (smoke qwen3-moe-30b-a3b: softmax routing, top-2 from 2 of 4 groups,
  its input drawn from the reference's key) and on DeepSeek-V3 smoke;
* on (pod, data, model) meshes, the batch cut over the pair ``("pod",
  "data")``: ``ep_flat`` and ``ep_dedup`` at (2, 2, 2) (where the 4 groups
  do not divide 2 columns, ``ep_dedup`` runs ``ep_flat``, as the
  reference's does) and ``ep_dedup`` at (2, 1, 4); ``ep_ftp`` (each
  position's tokens gathered over the pair, the expert FF cut over
  ``"data"`` and summed over it alone) at (2, 2, 2) and (2, 1, 4), with
  fp32 and with FP8 experts: all within 1e-4 of max|y|. The reference's
  ``ep_ftp`` sums its partials over every data axis, which multiplies the
  routed experts by |pod| on such a mesh; the planted case that sums over
  the pair must fail the bound;
* ``ep_ftp`` with FP8 experts on (2, 4) (DeepSeek-V3 smoke with its FP8
  GEMMs, expert FF 256: 128 a data rank) within 0.05 of the single
  device, and within ``FTP_FP8_TOL`` of the reference's
  ``moe_ffn_sharded`` of the same case, computed in the JAX subprocess;
  the same on the engine's weights (``Fp8Experts`` codes prepared whole,
  cut by ``shard_tree``, ``fp8_impl="pallas"``) within ``FTP_FP8_TOL``
  of the reference's kernel route; a cut inside a
  128-block raises, for plain weights and E4M3 codes, and whole blocks
  cut along D and F dequantize to the whole stack's slice.

The reference's own ``ep_ftp`` on the pod meshes, run in the JAX
subprocess on the same layer and tokens, returns the routed experts'
output |pod| = 2 times (``ROADMAP.md`` §C); at (2, 4) once.

The port's cut of an (8, k) array over ``("pod", "data")`` on (2, 2, 2)
and (2, 1, 4) is, rank by rank, the reference's placement of the same
``PartitionSpec`` (``devices_indices_map`` in the JAX subprocess).

The wire codec is bitwise JAX's, in process. ``decode_alltoall_bytes()``
on ``benchmarks/train_bench.bench_config()`` at (2, 4), 64 slots: the
port's value is what one decode step's all-to-alls really move per MoE
layer, ``ep_dedup`` < ``ep_flat``, and both equal the reference's, read
off its lowering in one JAX subprocess on 8 host devices (run beside the
ranks). The module takes about 40 s.
"""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ep
from repro.configs.base import get_config, smoke_config
from repro.core import moe as jmoe
from repro.models.api import Model as JModel
from repro.parallel import ep as jep
from repro_torch.parallel import ep

WORLD = 8
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")
# per-case x shapes (the reference's TestEP), besides ftp_split and the
# pod cases
SHAPES = {"flat": (4, 16), "dedup": (4, 16), "dedup_cpg2": (8, 8),
          "ftp": (3, 1), "ftp_split": (4, 1), "fp8_wire": (4, 16),
          "fp8_wire_qwen3_moe": (4, 16), "ftp_fp8": (4, 2),
          "pod_flat": (4, 16), "pod_dedup": (4, 16),
          "pod_dedup_2x1x4": (4, 16), "pod_ftp": (4, 1),
          "pod_ftp_2x1x4": (4, 2), "pod_ftp_fp8": (4, 1),
          "pod_ftp_fp8_2x1x4": (4, 2)}
# cases whose output must fail the bound (a planted fault), by the case
# whose input and reference they share
FAULTS = {"pod_ftp_pair_sum": "pod_ftp"}
TOL = {"fp8_wire": 0.05, "fp8_wire_qwen3_moe": 0.05, "ftp_fp8": 0.05}
# the port's ``ep_ftp`` with FP8 experts against the reference's
# ``moe_ffn_sharded`` of the same case (the same E4M3 tiles and blocks,
# each rank's slice of the expert FF quantized on its own; fp32 sums in
# another order move a value by ulps, which at most flips a code)
FTP_FP8_TOL = 1e-5
# the reference's draw of each case's input (keys 1, 2, ... otherwise)
KEYS = {"fp8_wire_qwen3_moe": 1}

JAX_BYTES = """
import json
from repro.compat import make_mesh as mk
from repro.parallel import context as pctx_mod
from repro.serve.engine import ServeEngine
from benchmarks.train_bench import bench_config

cfg = bench_config()
mesh = mk((2, 4), ("data", "model"))
for impl in ("ep_flat", "ep_dedup"):
    ctx = pctx_mod.ParallelCtx(mesh=mesh, dp_axes=("data",),
                               moe_impl=impl, wire="fp8")
    eng = ServeEngine(cfg, slots={slots}, max_len=32, chunk=8, ctx=ctx)
    print("BYTES", impl, eng.decode_alltoall_bytes())

# ep_ftp with FP8 experts on (2, 4): the reference's sharded MoE
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs.base import get_config, smoke_config
from repro.parallel import ep as jep
inputs = np.load("{d}/inputs.npz")
c = smoke_config(get_config("deepseek-v3-671b"))
c = dataclasses.replace(c, fp8=True, moe=dataclasses.replace(
    c.moe, capacity_factor=8.0, expert_ff=256))
p = {{k.split(":")[2]: jnp.asarray(inputs[k][0]) for k in inputs.files
      if k.startswith("p:dsv3-fp8:")}}
ctx = pctx_mod.ParallelCtx(mesh=mesh, dp_axes=("data",), moe_impl="ep_flat",
                           wire="fp8", ep_ftp=True)
with pctx_mod.use(ctx):
    y = jax.jit(lambda p, x: jep.moe_ffn_sharded(p, x, c, ctx)[0])(
        p, jnp.asarray(inputs["x:ftp_fp8"]))
np.save("{d}/ftp_fp8_ref.npy", np.asarray(y))
# the same on the kernel route (``fp8_impl="pallas"``: ``moe_gemm``, no
# qdq of the hidden state between the products), the route of the
# engine's Fp8Experts codes
c = dataclasses.replace(c, fp8_impl="pallas")
with pctx_mod.use(ctx):
    y = jax.jit(lambda p, x: jep.moe_ffn_sharded(p, x, c, ctx)[0])(
        p, jnp.asarray(inputs["x:ftp_fp8"]))
np.save("{d}/ftp_fp8_codes_ref.npy", np.asarray(y))

# the reference's placement of an (8, k) array cut over ("pod", "data")
from jax.sharding import NamedSharding, PartitionSpec as P
for shape in ((2, 2, 2), (2, 1, 4)):
    m = mk(shape, ("pod", "data", "model"))
    idx = NamedSharding(m, P(("pod", "data"), None)).devices_indices_map(
        (8, 3))
    rows = [idx[dev][0].indices(8)[:2] for dev in m.devices.reshape(-1)]
    print("PLACE", "x".join(map(str, shape)), json.dumps(rows))

# the reference's ep_ftp on pod meshes (fp8 off, capacity 8, fp32 wire,
# ep_dedup): its routed part against the unmeshed moe_ffn's, as the
# projection ratio and the relative error
from repro.core import moe as jmoe
c = smoke_config(get_config("deepseek-v3-671b"))
c = dataclasses.replace(c, fp8=False, moe=dataclasses.replace(
    c.moe, capacity_factor=8.0))
p = {{k.split(":")[2]: jnp.asarray(inputs[k][0]) for k in inputs.files
      if k.startswith("p:deepseek-v3-671b:")}}
x = jnp.asarray(inputs["x:pod_ftp"])
shared = jmoe.shared_expert(p, x, c)
want = np.asarray(jmoe.moe_ffn(p, x, c)[0] - shared).ravel()
for shape, axes, dp in (((2, 4), ("data", "model"), ("data",)),
                        ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
                        ((2, 1, 4), ("pod", "data", "model"), ("pod", "data"))):
    ctx = pctx_mod.ParallelCtx(mesh=mk(shape, axes), dp_axes=dp,
                               moe_impl="ep_dedup", wire="fp32", ep_ftp=True)
    with pctx_mod.use(ctx):
        y = jax.jit(lambda p, x: jep.moe_ffn_sharded(p, x, c, ctx)[0])(p, x)
    got = np.asarray(y - shared).ravel()
    print("FTPREF", "x".join(map(str, shape)), float(got @ want / (want @ want)),
          float(np.abs(got - want).max() / np.abs(want).max()))
"""


def _config(arch=_torch_ep.DSV3):
    arch, over = _torch_ep.CONFIGS.get(arch, (arch, {}))
    cfg = smoke_config(get_config(arch))
    moe = dict(capacity_factor=8.0)
    if "expert_ff" in over:
        moe["expert_ff"] = over["expert_ff"]
    return dataclasses.replace(cfg, fp8=over.get("fp8", False),
                               moe=dataclasses.replace(cfg.moe, **moe))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    inputs, refs, layers = {}, {}, {}
    for arch in {_torch_ep.DSV3, *_torch_ep.ARCHS.values()}:
        params = JModel(_config(arch)).init(jax.random.PRNGKey(0))
        layers[arch] = pm = jax.tree.map(lambda x: x[0],
                                         params["blocks"])["moe"]
        for k, v in pm.items():
            inputs[f"p:{arch}:{k}"] = np.asarray(v)[None]  # one layer
    for i, (name, shape) in enumerate(SHAPES.items()):
        arch = _torch_ep.ARCHS.get(name, _torch_ep.DSV3)
        cfg = _config(arch)
        x = jax.random.normal(jax.random.PRNGKey(KEYS.get(name, 1 + i)),
                              shape + (cfg.d_model,), jnp.float32) * 0.5
        inputs["x:" + name] = np.asarray(x)
        y, _, _ = jmoe.moe_ffn(layers[arch], x, cfg, capacity_override=512)
        refs[name] = np.asarray(y)
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join([SRC, ROOT,
                                         env.get("PYTHONPATH", "")])
    jax_side = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_BYTES.format(
            slots=_torch_ep.BYTES_SLOTS, d=d))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=_torch_ep.run_rank,
                         args=(r, WORLD, str(d / "store"), str(d)))
             for r in range(WORLD)]
    for p in ranks:
        p.start()
    for p in ranks:
        p.join(timeout=300)
    codes = [p.exitcode for p in ranks]
    for p in ranks:
        if p.is_alive():
            p.kill()
    out, err = jax_side.communicate(timeout=300)
    assert codes == [0] * WORLD, codes
    assert jax_side.returncode == 0, err[-3000:]
    jbytes = {line.split()[1]: int(line.split()[2])
              for line in out.splitlines() if line.startswith("BYTES")}
    jbytes["place"] = {line.split(" ", 2)[1]: json.loads(
        line.split(" ", 2)[2]) for line in out.splitlines()
        if line.startswith("PLACE")}
    jbytes["ftp_ref"] = {line.split()[1]: tuple(map(float, line.split()[2:]))
                         for line in out.splitlines()
                         if line.startswith("FTPREF")}
    ours = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    for name in ("ftp_fp8", "ftp_fp8_codes"):
        refs["sharded:" + name] = np.load(d / f"{name}_ref.npy")
    return refs, ours, jbytes


def _rows(name, rank):
    """The slice of the batch rank ``rank`` returned for case ``name``."""
    shape, _, _, _, layout = _torch_ep.CASES[name]
    B = SHAPES[FAULTS.get(name, name)][0]
    rows = int(np.prod(shape[:-1]))         # the data row: the pair's
    if layout == "split" and rows > 1:
        d = rank // shape[-1]
        per = B // rows
        return slice(d * per, (d + 1) * per)
    return slice(0, B)


def _err(run, name):
    """Each member's max error over max|y| against the single device."""
    refs, ours, _ = run
    ref = refs[FAULTS.get(name, name)]
    scale = np.abs(ref).max()
    members = [r for r in range(WORLD) if name in ours[r]]
    assert len(members) == np.prod(_torch_ep.CASES[name][0])
    out = []
    for r in members:
        y = ours[r][name]
        want = ref[_rows(name, r)]
        assert y.shape == want.shape, (r, y.shape, want.shape)
        out.append(np.abs(y - want).max() / scale)
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_ep_matches_single_device_moe(run, name):
    for r, err in enumerate(_err(run, name)):
        assert err < TOL.get(name, 1e-4), (name, r, err)


@pytest.mark.parametrize("name", list(FAULTS))
def test_ftp_partials_summed_over_the_pair_fail_the_bound(run, name):
    """The reference's ``ep_ftp`` on a pod mesh, planted in the port: the
    expert-FF partials summed over the pair ``("pod", "data")`` count
    every "data" partial |pod| times; on every rank the result is outside
    the bound the sound case holds."""
    errs = _err(run, name)
    print(name, "errors over max|y|", errs)
    assert min(errs) > 1e-4, errs


def test_references_ftp_counts_each_partial_once_per_pod(run):
    """The reference's own ``ep_ftp`` on the same DeepSeek-V3 smoke layer
    and tokens (fp8 off, capacity 8, fp32 wire, ``ep_dedup``), its routed
    part against the unmeshed ``moe_ffn``'s: at (2, 4) the same (ratio
    1); on the pod meshes (2, 2, 2) and (2, 1, 4) twice it, |pod| times,
    since it sums the "data"-cut partials over "pod" too. The port's
    ``pod_ftp`` cases hold ratio 1 (``test_ep_matches_single_device_moe``)
    and so do not copy it."""
    _, _, jbytes = run
    got = jbytes["ftp_ref"]
    print("the reference's ep_ftp: (projection ratio, relative error)", got)
    assert set(got) == {"2x4", "2x2x2", "2x1x4"}, got
    ratio, err = got["2x4"]
    assert abs(ratio - 1) < 1e-5 and err < 1e-4, got
    for shape in ("2x2x2", "2x1x4"):
        ratio, err = got[shape]
        assert abs(ratio - 2) < 1e-5 and err > 1e-2, got


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 1, 4)])
def test_pair_cut_equals_the_references_placement(run, shape):
    """``cut_leaf`` of an (8, 3) array over ``("pod", "data")`` on each
    rank, and each rank's ``dp_index``, against the reference's placement
    of ``PartitionSpec(("pod", "data"), None)`` on the same mesh: the pair
    is cut pod-major, ``pod * |data| + data``."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.context import Mesh, ParallelCtx
    _, _, jbytes = run
    want = jbytes["place"]["x".join(map(str, shape))]
    a = torch.arange(24.0).reshape(8, 3)
    for r in range(WORLD):
        mesh = Mesh(shape, _torch_ep.POD_AXES, rank=r)
        got = sh.cut_leaf(a, sh.P(("pod", "data"), None), mesh)
        lo, hi = want[r]
        assert torch.equal(got, a[lo:hi]), (r, got, want[r])
        ctx = ParallelCtx(mesh=mesh, dp_axes=("pod", "data"))
        assert ctx.dp_index == lo // (8 // ctx.dp_size), (r, want[r])


@pytest.mark.parametrize("name", ["ftp_fp8", "ftp_fp8_codes"])
def test_ftp_fp8_matches_the_references_sharded_moe(run, name):
    """``ep_ftp`` with FP8 experts (DeepSeek-V3 smoke, expert FF 256 cut
    into 128 a data rank, (2, 4), FP8 wire) against the reference's
    ``moe_ffn_sharded`` of the same case on 8 host devices: within
    ``FTP_FP8_TOL`` of max|y| on every rank. ``ftp_fp8`` feeds dense
    block-qdq weights; ``ftp_fp8_codes`` the engine's ``Fp8Experts``
    codes, cut along F (w1, w3) and D (w2) by ``shard_tree``, on the
    kernel route (``fp8_impl="pallas"``), held against the reference's
    kernel route."""
    refs, ours, _ = run
    ref = refs["sharded:" + name]
    scale = np.abs(ref).max()
    for r in range(WORLD):
        err = np.abs(ours[r][name] - ref).max() / scale
        assert err < FTP_FP8_TOL, (r, err)


@pytest.mark.parametrize("cut", ["dense", "codes"])
def test_ftp_fp8_refuses_a_cut_inside_a_block(cut):
    """Where the data axis cuts the expert FF dimension into parts that
    are not whole 128-blocks (smoke DeepSeek-V3's 64 over 2), ``ep_ftp``
    with FP8 experts raises a ``ValueError`` that says so, for the plain
    weights and for ``Fp8Experts`` codes."""
    from repro_torch.configs.base import get_config as tget
    from repro_torch.configs.base import smoke_config as tsmoke
    from repro_torch.core.fp8 import Fp8Experts
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.context import Mesh
    cfg = tsmoke(tget(_torch_ep.DSV3))
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_ff
    w = torch.randn(E, d, f, generator=torch.Generator().manual_seed(0))
    if cut == "dense":
        with pytest.raises(ValueError, match="not a multiple of 128"):
            ep._check_ftp_blocks({"w1": w[..., :f // 2]}, cfg)
        ep._check_ftp_blocks({"w1": w}, cfg)          # uncut: no check
        return
    mesh = Mesh((2, 4), rank=5)
    with pytest.raises(ValueError, match="not whole 128-blocks"):
        sh.cut_leaf(Fp8Experts.quantize(w), sh.P("model", None, "data"),
                    mesh)
    # mesh (2, 4) rank 5: data row 1, model column 1
    big = torch.randn(4, d, 256, generator=torch.Generator().manual_seed(1))
    part = sh.cut_leaf(Fp8Experts.quantize(big), sh.P(None, None, "data"),
                       mesh)
    assert part.shape == (4, d, 128)
    torch.testing.assert_close(part.dequant(),
                               Fp8Experts.quantize(big).dequant()[..., 128:],
                               rtol=0, atol=0)
    # the D cut w2 takes under ep_ftp, experts over the model axis
    tall = torch.randn(8, 256, d, generator=torch.Generator().manual_seed(2))
    part = sh.cut_leaf(Fp8Experts.quantize(tall),
                       sh.P("model", "data", None), mesh)
    assert part.shape == (2, 128, d)
    torch.testing.assert_close(
        part.dequant(), Fp8Experts.quantize(tall).dequant()[2:4, 128:],
        rtol=0, atol=0)


def test_every_model_column_returns_the_same_tokens(run):
    """Tokens are replicated over the model columns of a data row: every
    column's output for them is the same bytes."""
    _, ours, _ = run
    for name in ("flat", "dedup"):
        for d in range(2):
            ys = [ours[4 * d + m][name] for m in range(4)]
            for y in ys[1:]:
                np.testing.assert_array_equal(y, ys[0])


@pytest.mark.parametrize("wire", ["fp8", "bf16", "fp32"])
def test_wire_codec_bitwise_equal_to_jax(wire):
    g = np.random.default_rng([26, len(wire)])
    x = (g.standard_normal((3, 5, 384)) * np.exp(
        g.uniform(-6, 6, (3, 5, 1)))).astype(np.float32)
    xt = torch.from_numpy(x)
    q, s = ep._wire_encode(xt, wire)
    jq, js = jep._wire_encode(jnp.asarray(x), wire)
    assert q.dtype == {"fp8": torch.uint8, "bf16": torch.bfloat16,
                       "fp32": torch.float32}[wire]
    np.testing.assert_array_equal(
        q.view(torch.uint8 if wire == "fp8" else torch.int16
               if wire == "bf16" else torch.int32).numpy(),
        np.asarray(jq).view(np.uint8 if wire == "fp8" else np.int16
                            if wire == "bf16" else np.int32))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        y = ep._wire_decode(q, s, dt, wire)
        jy = jep._wire_decode(jq, js, jdt, wire)
        np.testing.assert_array_equal(
            y.float().numpy(), np.asarray(jy.astype(jnp.float32)))


def test_decode_alltoall_bytes_dedup_below_flat_and_equal_to_reference(run):
    """The §4.3 dedup claim on the serving hot path, on the reference's
    own case: each rank's value is what one decode step moves per MoE
    layer, the same on every rank, and equal to the reference's lowering
    read."""
    _, ours, jbytes = run
    jbytes = {k: v for k, v in jbytes.items()
              if k not in ("place", "ftp_ref")}
    got = {}
    for impl in ("ep_flat", "ep_dedup"):
        vals = {tuple(ours[r]["bytes:" + impl]) for r in range(WORLD)}
        assert len(vals) == 1, vals
        claimed, moved = vals.pop()
        assert claimed == moved, (impl, claimed, moved)
        got[impl] = claimed
    assert 0 < got["ep_dedup"] < got["ep_flat"], got
    assert got == jbytes, (got, jbytes)


def test_capacity_matches_reference():
    from repro_torch.configs.base import get_config as tget
    from repro_torch.core import moe as tmoe
    jm, tm = get_config("deepseek-v3-671b").moe, tget("deepseek-v3-671b").moe
    for t in (1, 7, 64, 513):
        for e, k in ((None, None), (4, 1), (8, 2), (32, 3)):
            assert tmoe.capacity(t, tm, experts=e, k=k) == \
                jmoe.capacity(t, jm, experts=e, k=k)
            assert int(tmoe.capacity_dynamic(torch.tensor(t), tm,
                                             experts=e, k=k)) == \
                int(jmoe.capacity_dynamic(jnp.asarray(t), jm, experts=e,
                                          k=k))
