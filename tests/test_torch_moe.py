"""PyTorch port: node-limited routing, capacity dispatch, the MoE layer
and the moe_gemm kernel op against the JAX reference (``repro.core.
routing``, ``repro.core.moe``, ``repro.kernels.moe_gemm``).

Same inputs from numpy seeds on both sides; routing decisions and drops
are held equal, values to fp32 tolerance (1e-5 of the largest reference
magnitude) — bf16 cases to one bf16 rounding step (2^-7).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, smoke_config
from repro.core import moe as jmoe
from repro.core import routing as jrouting
from repro.kernels.moe_gemm import ops as jmoe_ops
from repro.models.api import Model as JModel
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import fp8, moe, routing
from repro_torch.kernels import registry
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.models.param import layer as param_layer
from _torch_threads import one_thread  # noqa: F401


RTOL = 1e-5
BF16_RTOL = 2 ** -7


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rtol * scale, f"max err {err} > {rtol} x {scale}"


def _cfgs(fp8_impl="ref", capacity_factor=1.25):
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    out = []
    for c in (cfg, tcfg):
        c = dataclasses.replace(c, fp8_impl=fp8_impl, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor))
        out.append(c)
    return out


@pytest.fixture(scope="module")
def moe_params():
    """One MoE layer's weights from the JAX init, in both packages, with a
    non-zero router bias so selection and mixture weights differ."""
    cfg, _ = _cfgs()
    jp = jax.tree.map(lambda v: v[0], JModel(cfg).init(
        jax.random.PRNGKey(1))["blocks"]["moe"])
    bias = _gen("bias").standard_normal(cfg.moe.num_experts) * 0.05
    jp = dict(jp, bias=jnp.asarray(bias, jnp.float32))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return jp, tp


class TestRouting:
    @pytest.mark.parametrize("T", [1, 6, 33])
    def test_route_matches_jax(self, moe_params, T):
        (cfg, tcfg), (jp, tp) = _cfgs(), moe_params
        x = _gen(("route", T)).standard_normal((T, cfg.d_model)).astype(
            np.float32)
        ref = jrouting.route(jnp.asarray(x), jp["w_gate"], cfg.moe,
                             bias=jp["bias"])
        ours = routing.route(torch.from_numpy(x), tp["w_gate"], tcfg.moe,
                             bias=tp["bias"])
        np.testing.assert_array_equal(ours.expert_idx.numpy(),
                                      np.asarray(ref.expert_idx))
        _close(ours.weights, ref.weights)
        _close(ours.scores, ref.scores)

    def test_full_width_groups_are_node_limited(self):
        """Published routing (8 groups, limit 4): each token's experts fall
        in at most 4 groups."""
        mc = tget("deepseek-v3-671b").moe
        g = _gen("groups")
        x = torch.from_numpy(g.standard_normal((16, 64)).astype(np.float32))
        w = torch.from_numpy(g.standard_normal((64, 256)).astype(np.float32))
        rr = routing.route(x, w, mc)
        groups = rr.expert_idx.long() // (256 // 8)
        per_token = [len(set(r.tolist())) for r in groups]
        assert max(per_token) <= 4 and rr.expert_idx.shape == (16, 8)


class TestDispatch:
    @pytest.mark.parametrize("T,k,E,C", [(6, 2, 8, 8), (40, 2, 8, 8),
                                         (64, 8, 32, 16)])
    @pytest.mark.parametrize("masked", [False, True])
    def test_dispatch_plan_equal(self, T, k, E, C, masked):
        g = _gen(("plan", T, k, E, C, masked))
        idx = np.stack([g.choice(E, k, replace=False)
                        for _ in range(T)]).astype(np.int32)
        valid = (np.arange(T) < T - 3) if masked else None
        cap = 8 if masked else None
        ref = jmoe.dispatch_plan(
            jnp.asarray(idx), E, C,
            valid=None if valid is None else jnp.asarray(valid),
            cap_limit=None if cap is None else jnp.asarray(cap))
        ours = moe.dispatch_plan(
            torch.from_numpy(idx), E, C,
            valid=None if valid is None else torch.from_numpy(valid),
            cap_limit=None if cap is None else torch.tensor(cap))
        np.testing.assert_array_equal(ours.keep.numpy(), np.asarray(ref.keep))
        np.testing.assert_array_equal(ours.dest.numpy(), np.asarray(ref.dest))
        assert float(ours.drop_frac) == pytest.approx(float(ref.drop_frac))

    def test_capacity_rules_equal(self):
        mc = tget("deepseek-v3-671b").moe
        jmc = get_config("deepseek-v3-671b").moe
        for t in (1, 4, 8, 100, 1024, 4096):
            assert moe.capacity(t, mc) == jmoe.capacity(t, jmc)
            assert int(moe.capacity_dynamic(torch.tensor(t), mc)) == int(
                jmoe.capacity_dynamic(jnp.asarray(t), jmc))
        assert moe.capacity(4, mc) == 8        # decode: the 8-row floor


class TestMoeLayer:
    @pytest.mark.parametrize("fp8_impl", ["ref", "pallas"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_moe_ffn_matches_jax_drops_equal(self, moe_params, fp8_impl,
                                             masked):
        (cfg, tcfg), (jp, tp) = _cfgs(fp8_impl), moe_params
        x = _gen(("ffn", fp8_impl, masked)).standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
        valid = (np.arange(12)[None, :] < np.array([[12], [7]])) if masked \
            else None
        jy, jrr, jdrop = jmoe.moe_ffn(
            jp, jnp.asarray(x), cfg,
            valid=None if valid is None else jnp.asarray(valid))
        y, rr, drop = moe.moe_ffn(
            tp, torch.from_numpy(x), tcfg,
            valid=None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(rr.expert_idx.numpy(),
                                      np.asarray(jrr.expert_idx))
        assert float(drop) == pytest.approx(float(jdrop))
        assert float(drop) > 0          # capacity 1.25 at T=24 does drop
        _close(y, jy)

    def test_load_time_qdq_equals_per_call(self, moe_params):
        """bridge.prepare_for_serving stores the kernel path's routed
        experts as E4M3 codes and scales whose dequantized values are the
        per-call straight-through values bit for bit, so the layer's output
        is the per-call one exactly."""
        (_, tcfg), (_, tp) = _cfgs("pallas"), moe_params
        x = torch.from_numpy(_gen("prep").standard_normal(
            (1, 9, tcfg.d_model)).astype(np.float32))
        before = {k: tp[k].clone() for k in ("w1", "w3", "w2")}
        prep = bridge.prepare_for_serving({"moe": tp}, tcfg)
        for k in before:                     # copied, not in place
            assert bridge.same_bits(tp[k], before[k])
        assert prep["plain_expert_matrices"] == 0
        pm = prep["moe"]
        for k in ("w1", "w3", "w2"):
            assert isinstance(pm[k], fp8.Fp8Experts)
            assert pm[k].shape == tp[k].shape and pm[k].dtype == tp[k].dtype
            assert bridge.same_bits(pm[k].dequant(),
                                    moe.ste_qdq_block(tp[k]))
        a, _, _ = moe.moe_ffn(tp, x, tcfg)
        b, _, _ = moe.moe_ffn(pm, x, tcfg, weights_qdq=True)
        assert torch.equal(a, b)

    def test_a_stack_that_fails_the_check_stays_plain_and_counts(self):
        """The check helper, fed codes of other weights, keeps the
        straight-through tensor and counts its matrices."""
        g = _gen("fails")
        w = torch.from_numpy(g.standard_normal((2, 3, 200, 72)).astype(
            np.float32) * 0.02).bfloat16()
        other = fp8.Fp8Experts.quantize(w * 2)
        kept, n = bridge.check_experts(w, other, inplace=False)
        assert n == 6 and isinstance(kept, torch.Tensor)
        want = torch.stack([moe.ste_qdq_block(m) for m in w.reshape(
            -1, 200, 72)]).reshape(w.shape)
        assert bridge.same_bits(kept, want)
        same, n = bridge.check_experts(w, fp8.Fp8Experts.quantize(w), False)
        assert n == 0 and isinstance(same, fp8.Fp8Experts)


class TestFp8Experts:
    @pytest.mark.parametrize("shape", [(3, 200, 72), (2, 2, 256, 384)])
    @pytest.mark.parametrize("dtype", ["bfloat16", np.float32])
    def test_dequant_equals_per_call_ste_bitwise(self, shape, dtype):
        """dtype(code x scale) is the reference's straight-through block
        qdq (JAX, eager) and the port's per-call one, bit for bit; tiny
        negative weights (codes of -0) included."""
        w = _gen(("experts", shape, str(dtype))).standard_normal(shape)
        w = w.astype(np.float32) * 0.02
        w.reshape(-1)[:16] = -1e-30
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        jw = jnp.asarray(w, jdt)
        tw = bridge.params_from_jax(np.asarray(jw))
        c = fp8.Fp8Experts.quantize(tw)
        assert c.shape == tw.shape and c.dtype == tw.dtype
        got = c.dequant()
        flat = jw.reshape(-1, *shape[-2:])
        ref = np.stack([np.asarray(jmoe.ste_qdq_block(flat[i]))
                        for i in range(flat.shape[0])]).reshape(shape)
        assert bridge.same_bits(got, bridge.params_from_jax(ref))
        assert bridge.same_bits(got, torch.stack([
            fp8.ste_qdq(m, fp8.qdq_block)
            for m in tw.reshape(-1, *shape[-2:])]).reshape(shape))

    def test_layer_slices_the_container(self):
        w = torch.from_numpy(_gen("layer").standard_normal(
            (3, 2, 200, 72)).astype(np.float32))
        c = fp8.Fp8Experts.quantize(w)
        one = param_layer({"moe": {"w1": c}}, 1)["moe"]["w1"]
        assert isinstance(one, fp8.Fp8Experts)
        assert one.shape == (2, 200, 72)
        assert torch.equal(one.dequant(), c.dequant()[1])
        assert torch.equal(one.dequant(), fp8.Fp8Experts.quantize(
            w[1]).dequant())


MOE_GEMM_CASES = [((2, 16, 32, 24), np.float32), ((4, 128, 128, 128), np.float32),
                  ((4, 128, 128, 128), "bfloat16"), ((1, 8, 256, 64), "bfloat16"),
                  ((3, 40, 72, 96), np.float32)]


class TestGroupedMatmulOp:
    @pytest.mark.parametrize("dims,dtype", MOE_GEMM_CASES)
    def test_plain_matches_jax_interpret_kernel(self, dims, dtype):
        E, C, D, F = dims
        g = _gen(("moe_gemm", dims, str(dtype)))
        x = g.standard_normal((E, C, D)).astype(np.float32)
        w = g.standard_normal((E, D, F)).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        # round to the working dtype once, then hand both sides the bits
        jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
        tx = bridge.params_from_jax(np.asarray(jx))
        tw = bridge.params_from_jax(np.asarray(jw))
        ref = jmoe_ops.grouped_matmul(jx, jw)
        ours = moe_ops.grouped_matmul(tx, tw)
        assert ours.dtype == tdt
        _close(ours, ref, RTOL if dtype == np.float32 else BF16_RTOL)

    @pytest.mark.parametrize("dims,dtype", MOE_GEMM_CASES)
    def test_container_plain_matches_jax_interpret_kernel(self, dims, dtype):
        """The container's plain version against the JAX interpret kernel
        on the reference's straight-through weights."""
        E, C, D, F = dims
        g = _gen(("moe_gemm_fp8", dims, str(dtype)))
        x = g.standard_normal((E, C, D)).astype(np.float32)
        w = g.standard_normal((E, D, F)).astype(np.float32) * 0.02
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
        tx = bridge.params_from_jax(np.asarray(jx))
        tw = fp8.Fp8Experts.quantize(bridge.params_from_jax(np.asarray(jw)))
        ref = jmoe_ops.grouped_matmul(jx, jmoe.ste_qdq_block(jw))
        ours = moe_ops.grouped_matmul(tx, tw)
        assert ours.dtype == tx.dtype
        _close(ours, ref, RTOL if dtype == np.float32 else BF16_RTOL)

    def test_cpu_runs_plain_and_counts_nothing(self):
        registry.reset_launch_counts()
        moe_ops.grouped_matmul(torch.ones(2, 8, 16), torch.ones(2, 16, 8))
        assert registry.launch_counts()["moe_gemm"] == 0


class TestExpertDtype:
    """E4M3 expert storage (``cfg.expert_dtype``, the reference's serving
    option): the routed experts are stored as E4M3 and cast to the model
    dtype at use, with no scale and no qdq (FP8 GEMMs off, as the dry run
    sets them)."""

    @pytest.fixture(scope="class")
    def e4m3(self):
        cfg = dataclasses.replace(smoke_config(get_config(
            "deepseek-v3-671b")), expert_dtype="float8_e4m3fn", fp8=False)
        tcfg = dataclasses.replace(tsmoke(tget("deepseek-v3-671b")),
                                   expert_dtype="float8_e4m3fn", fp8=False)
        jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
        npp = jax.tree.map(np.asarray, jp)
        return cfg, tcfg, jp, npp

    def test_logits_match_jax(self, e4m3):
        """The bridged E4M3 stacks are the JAX init's codes, the port's own
        specs store them so, ``prepare_for_serving`` keeps them as they are
        (no ``Fp8Experts``), and the prefill logits agree within 1e-5."""
        from repro_torch.models.api import Model
        cfg, tcfg, jp, npp = e4m3
        tp = bridge.params_from_jax(npp)
        stacks = [v for k, v in _moe_leaves(tp) if k in ("w1", "w3", "w2")]
        assert stacks and all(v.dtype == torch.float8_e4m3fn for v in stacks)
        specs = [s for k, s in _moe_leaves(Model(tcfg, device="meta").specs())
                 if k in ("w1", "w3", "w2")]
        assert all(s.dtype == "float8_e4m3fn" for s in specs)
        prep = bridge.prepare_for_serving(
            tp, dataclasses.replace(tcfg, fp8=True, fp8_impl="pallas"))
        assert bridge.expert_storage(prep)["e4m3"] == 0
        assert all(p.dtype == torch.float8_e4m3fn for k, p in
                   _moe_leaves(prep) if k in ("w1", "w3", "w2"))
        toks = _gen("e4m3_tokens").integers(0, cfg.vocab_size, (1, 12))
        jl, _ = jax.jit(lambda p, t: JModel(cfg).prefill(
            p, {"tokens": t}))(jp, jnp.asarray(toks))
        tl, _ = Model(tcfg, device="cpu").prefill(
            bridge.prepare_for_serving(tp, tcfg),
            {"tokens": torch.from_numpy(toks)})
        _close(tl, jl)

    def test_greedy_stream_equals_jax(self, e4m3):
        from repro.serve.engine import Request as JRequest
        from repro.serve.engine import ServeEngine as JServeEngine
        from repro_torch.serve.engine import Request, ServeEngine
        cfg, tcfg, jp, npp = e4m3
        prompts = [np.arange(5 + 3 * i) * (i + 2) % cfg.vocab_size
                   for i in range(3)]
        out = []
        for port in (False, True):
            eng = (ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                               slots=2, max_len=32, chunk=4, device="cpu")
                   if port else JServeEngine(cfg, params=jp, slots=2,
                                             max_len=32, chunk=4))
            R = Request if port else JRequest
            reqs = [R(i, p, max_new=6) for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            assert all(r.done for r in reqs)
            out.append([list(r.out) for r in reqs])
        assert out[1] == out[0]


def _moe_leaves(tree, inside=False):
    """(name, leaf) of every leaf under a ``moe`` key."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _moe_leaves(v, inside or k == "moe")
        elif inside:
            yield k, v
