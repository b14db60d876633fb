"""PyTorch port: FP8 numerics and the fp8_gemm kernel op against the JAX
reference (``repro.core.fp8``, ``repro.kernels.fp8_gemm``).

Inputs come from numpy seeds and go to both packages. Quantization is held
bitwise; GEMMs to fp32 tolerance (1e-5 of the output's largest magnitude:
the two sides sum the same exact products in another order). The CUDA
kernels themselves are held against their plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels
from repro.core import fp8 as jfp8
from repro.core import paged as jpaged
from repro.kernels.fp8_gemm.fp8_gemm import fp8_gemm as jfp8_gemm_kernel
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.core import fp8, paged
from repro_torch.kernels import registry
from repro_torch.kernels.fp8_gemm import ops as fp8_ops
from repro_torch.models import layers

RTOL = 1e-5   # of max |reference|, fp32


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


def _bits(q):
    """E4M3 values as their bytes (torch or jax)."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(q, jnp.uint8))


class TestE4M3Decode:
    def test_all_256_codes_bitwise(self):
        codes = np.arange(256, dtype=np.uint8)
        ours = paged.e4m3_decode(torch.from_numpy(codes)).numpy()
        ref = np.asarray(jpaged.e4m3_decode(jnp.asarray(codes)))
        nan = np.isnan(ref)
        assert set(np.where(nan)[0]) == {0x7F, 0xFF}
        assert np.isnan(ours[nan]).all()
        assert (ours[~nan].view(np.uint32) == ref[~nan].view(np.uint32)).all()

    def test_accepts_e4m3_and_uint8(self):
        codes = torch.arange(256, dtype=torch.uint8)
        a = paged.e4m3_decode(codes)
        b = paged.e4m3_decode(codes.view(fp8.E4M3))
        keep = ~torch.isnan(a)
        assert torch.equal(a[keep], b[keep])


class TestQuantizationBitwise:
    @pytest.mark.parametrize("shape", [(4, 128), (3, 200), (2, 5, 384)])
    @pytest.mark.parametrize("heavy", [False, True])
    def test_tilewise(self, shape, heavy):
        g = _gen(("tile", shape, heavy))
        x = g.standard_normal(shape).astype(np.float32)
        if heavy:
            x *= np.exp(g.standard_normal(shape)).astype(np.float32)
        q, s = fp8.quantize_tilewise(torch.from_numpy(x))
        jq, js = jfp8.quantize_tilewise(jnp.asarray(x))
        np.testing.assert_array_equal(_bits(q), _bits(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            fp8.dequant_tilewise(q, s).numpy(),
            np.asarray(jfp8.dequant_tilewise(jq, js)))

    @pytest.mark.parametrize("shape", [(128, 128), (200, 72), (256, 384)])
    def test_blockwise(self, shape):
        w = _gen(("block", shape)).standard_normal(shape).astype(np.float32)
        q, s = fp8.quantize_blockwise(torch.from_numpy(w))
        jq, js = jfp8.quantize_blockwise(jnp.asarray(w))
        np.testing.assert_array_equal(_bits(q), _bits(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            fp8.qdq_block(torch.from_numpy(w)).numpy(),
            np.asarray(jfp8.qdq_block(jnp.asarray(w))))

    def test_blockwise_batched_matches_per_matrix(self):
        """The stacked-expert form equals the reference's vmap."""
        w = _gen("stack").standard_normal((3, 130, 260)).astype(np.float32)
        ours = fp8.qdq_block(torch.from_numpy(w)).numpy()
        ref = np.asarray(jax.vmap(jfp8.qdq_block)(jnp.asarray(w)))
        np.testing.assert_array_equal(ours, ref)

    @pytest.mark.parametrize("vec_ndim", [1, 2])
    def test_quantize_vecs(self, vec_ndim):
        x = _gen(("vecs", vec_ndim)).standard_normal(
            (3, 8, 4, 16)).astype(np.float32) * 3
        x[0, 0] = 0.0                           # an all-zero token vector
        q, s = paged.quantize_vecs(torch.from_numpy(x), vec_ndim)
        jq, js = jpaged.quantize_vecs(jnp.asarray(x), vec_ndim)
        np.testing.assert_array_equal(_bits(q), _bits(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            paged.dequantize_vecs(q, s, vec_ndim).numpy(),
            np.asarray(jpaged.dequantize_vecs(jq, js, vec_ndim)))


FP8_GEMM_CASES = [((128, 128, 128), False), ((256, 256, 128), True),
                  ((384, 512, 256), False), ((100, 200, 72), False),
                  ((128, 384, 384), True)]


def _gemm_inputs(shape, heavy):
    M, K, N = shape
    g = _gen(("gemm", shape, heavy))
    x = g.standard_normal((M, K)).astype(np.float32)
    w = g.standard_normal((K, N)).astype(np.float32)
    if heavy:
        x *= np.exp(g.standard_normal((M, K))).astype(np.float32)
    return x, w


def _to_jax_e4m3(q):
    return jax.lax.bitcast_convert_type(jnp.asarray(_bits(q)), jfp8.E4M3)


class TestFp8Gemm:
    @pytest.mark.parametrize("shape,heavy", FP8_GEMM_CASES)
    def test_plain_matches_jax_interpret_kernel(self, shape, heavy):
        """The op's plain version against the Pallas kernel (interpret
        mode) on the same quantized operands. (The operands are quantized
        eagerly: XLA rewrites ``amax / 448`` inside a jit, which moves
        the jitted JAX scales by an ulp.)"""
        x, w = _gemm_inputs(shape, heavy)
        M, N = x.shape[0], w.shape[1]
        xp = torch.from_numpy(x)
        xp = torch.nn.functional.pad(xp, (0, (-xp.shape[1]) % 128,
                                          0, (-M) % 128))
        wp = torch.from_numpy(w)
        wp = torch.nn.functional.pad(wp, (0, (-N) % 128,
                                          0, (-wp.shape[0]) % 128))
        xq, xs = fp8.quantize_tilewise(xp)
        wq, ws = fp8.quantize_blockwise(wp)
        ref = jfp8_gemm_kernel(_to_jax_e4m3(xq), jnp.asarray(xs.numpy()),
                               _to_jax_e4m3(wq), jnp.asarray(ws.numpy()),
                               bm=128, bn=128, interpret=True)
        ours = fp8_ops.fp8_gemm(xq, xs, wq, ws)
        _close(ours[:M, :N], np.asarray(ref)[:M, :N])

    @pytest.mark.parametrize("shape,heavy", FP8_GEMM_CASES[:3])
    def test_fp8_matmul_matches_jax_eager(self, shape, heavy):
        x, w = _gemm_inputs(shape, heavy)
        jq, js = jfp8.quantize_tilewise(jnp.asarray(x))
        wjq, wjs = jfp8.quantize_blockwise(jnp.asarray(w))
        ref = jfp8.scaled_matmul_ref(jq, js, wjq, wjs)
        ours = fp8_ops.fp8_matmul(torch.from_numpy(x), torch.from_numpy(w))
        _close(ours, ref)

    def test_load_time_weight_equals_per_call(self):
        """An Fp8Weight quantized once gives the per-call values exactly."""
        x, w = _gemm_inputs((64, 384, 256), True)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        wq, ws = fp8.quantize_blockwise(wt)
        a = fp8_ops.fp8_matmul(xt, wt)
        b = fp8_ops.fp8_matmul(xt, fp8.Fp8Weight(wt, wq, ws))
        assert torch.equal(a, b)

    @pytest.mark.parametrize("impl", ["ref", "pallas"])
    def test_fp8_linear_matches_jax(self, impl):
        x, w = _gemm_inputs((2 * 7, 256, 96), False)
        x3 = x.reshape(2, 7, 256)
        with kernels.use_backend("ref"):
            ref = jfp8.fp8_linear(jnp.asarray(x3), jnp.asarray(w), impl)
        ours = fp8.fp8_linear(torch.from_numpy(x3), torch.from_numpy(w), impl)
        assert ours.shape == (2, 7, 96)
        _close(ours, ref)

    def test_linear_gate_is_input_width(self):
        """fp8 only from 256 input features up, as layers.py:40."""
        cfg = tsmoke(tget("deepseek-v3-671b"))
        g = _gen("gate")
        for d_in in (128, 256):
            x = torch.from_numpy(g.standard_normal((3, d_in)).astype(np.float32))
            w = torch.from_numpy(g.standard_normal((d_in, 16)).astype(np.float32))
            dense = x @ w
            y = layers.linear(x, w, cfg)
            assert torch.equal(y, dense) == (d_in < 256)

    def test_cpu_tensors_run_the_plain_version(self):
        registry.reset_launch_counts()
        x, w = _gemm_inputs((16, 128, 128), False)
        fp8_ops.fp8_matmul(torch.from_numpy(x), torch.from_numpy(w))
        assert registry.launch_counts()["fp8_gemm"] == 0

    def test_prepare_for_serving_quantizes_linear_inputs_from_256(self):
        cfg = tsmoke(tget("deepseek-v3-671b"))
        from repro_torch.models.api import Model
        params = Model(cfg, device="cpu").init(seed=3)
        prep = bridge.prepare_for_serving(params, cfg)
        mlp = prep["dense0"]["mlp"]
        assert isinstance(mlp["w_down"], fp8.Fp8Weight)      # 256 -> 128
        assert isinstance(mlp["w_gate"], torch.Tensor)       # 128 -> 256
        assert prep["prepared"] and "prepared" not in params
        assert bridge.prepare_for_serving(prep, cfg) is prep
