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
from repro_torch.core import moe, routing
from repro_torch.kernels import registry
from repro_torch.kernels.moe_gemm import ops as moe_ops

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
        """bridge.prepare_for_serving's one-time expert qdq gives the
        per-call values exactly."""
        (_, tcfg), (_, tp) = _cfgs("pallas"), moe_params
        x = torch.from_numpy(_gen("prep").standard_normal(
            (1, 9, tcfg.d_model)).astype(np.float32))
        prep = bridge.prepare_for_serving({"moe": tp}, tcfg)["moe"]
        a, _, _ = moe.moe_ffn(tp, x, tcfg)
        b, _, _ = moe.moe_ffn(prep, x, tcfg, weights_qdq=True)
        assert torch.equal(a, b)
        assert not torch.equal(prep["w1"], tp["w1"])     # copied, not in place


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

    def test_cpu_runs_plain_and_counts_nothing(self):
        registry.reset_launch_counts()
        moe_ops.grouped_matmul(torch.ones(2, 8, 16), torch.ones(2, 16, 8))
        assert registry.launch_counts()["moe_gemm"] == 0
