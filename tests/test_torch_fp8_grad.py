"""PyTorch port: the FP8 linear's backward (``core/fp8.py``, an
``autograd.Function``) against the reference's ``custom_vjp``
(``repro.core.fp8.fp8_linear``, evaluated eagerly: its jitted forward can
differ from eager by an ulp in ``amax / 448``), the straight-through
quant-dequant under autograd, and ``fp8_gemm.operands`` on the backward's
operand shapes.

Inputs come from numpy seeds. Tolerances, relative to the largest
reference magnitude: 1e-6 for the gradients (the same E4M3 codes and
scales; the fp32 GEMM sums in another order), bit for bit for the STE
forward values and for every quantization.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fp8 as jfp8
from repro.core import moe as jmoe
from repro_torch.core import fp8, moe
from repro_torch.kernels.fp8_gemm import ops as fp8_ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this test process: the suite runs files in
    parallel workers on one CPU, and torch's default of a thread per core
    in each worker oversubscribes it (these smoke shapes then run up to a
    hundred times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-6


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _case(tag, T, d, f, lead=()):
    g = _gen(tag)
    x = g.standard_normal(lead + (T, d)).astype(np.float32)
    w = (g.standard_normal((d, f)) * 0.05).astype(np.float32)
    ct = g.standard_normal(lead + (T, f)).astype(np.float32)
    return x, w, ct


# (256, 512) x (512, 384); K = 64 in dx (w_kr's shape class: d_out 64);
# a token count that is no multiple of 128 (the dw tiles run over tokens);
# leading batch axes (the model's (B, S, d) activations)
SHAPES = {"256x512x384": (256, 512, 384, ()), "w_kr_k64": (256, 512, 64, ()),
          "ragged_tokens": (200, 384, 256, ()),
          "batched": (24, 256, 128, (2,))}


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fp8_linear_grads_match_the_reference_vjp(shape, impl):
    T, d, f, lead = SHAPES[shape]
    x, w, ct = _case(shape, T, d, f, lead)
    y_ref, vjp = jax.vjp(lambda a, b: jfp8.fp8_linear(a, b, "ref"),
                         jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = fp8.fp8_linear(tx, tw, impl)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(ct))
    assert _rel(y.detach(), y_ref) <= TOL
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
    assert _rel(dx, dx_ref) <= TOL
    assert _rel(dw, dw_ref) <= TOL


def test_fp8_linear_bf16_grads_keep_dtypes():
    x, w, ct = _case("bf16", 64, 256, 128)
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tw = torch.from_numpy(w).bfloat16().requires_grad_(True)
    y = fp8.fp8_linear(tx, tw)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(ct).bfloat16())
    assert (y.dtype, dx.dtype, dw.dtype) == (torch.bfloat16,) * 3
    jx, jw = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    _, vjp = jax.vjp(lambda a, b: jfp8.fp8_linear(a, b), jx, jw)
    jdx, jdw = vjp(jnp.asarray(ct, jnp.bfloat16))
    # one bf16 rounding of fp32 values within TOL of each other
    assert _rel(dx.float(), jdx) <= 2 ** -7
    assert _rel(dw.float(), jdw) <= 2 ** -7


def test_fp8_linear_skips_the_unneeded_product():
    x, w, ct = _case("frozen", 32, 256, 128)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w)                     # frozen weight
    y = fp8.fp8_linear(tx, tw)
    (dx,) = torch.autograd.grad(y, (tx,), torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda a: jfp8.fp8_linear(a, jnp.asarray(w)),
                     jnp.asarray(x))
    assert _rel(dx, vjp(jnp.asarray(ct))[0]) <= TOL


def test_fp8_linear_grads_close_to_exact():
    """Mirror of tests/test_fp8.py: the FP8 gradients within 0.15 of the
    largest exact gradient (quantization noise of the backward GEMMs)."""
    g = _gen("close")
    x = torch.from_numpy(g.standard_normal((32, 256)).astype(np.float32))
    w = torch.from_numpy(
        (g.standard_normal((256, 128)) * 0.05).astype(np.float32))
    ct = torch.from_numpy(g.standard_normal((32, 128)).astype(np.float32))

    def grads(fn):
        a = x.clone().requires_grad_(True)
        b = w.clone().requires_grad_(True)
        return torch.autograd.grad((fn(a, b) * ct).sum(), (a, b))

    g8 = grads(fp8.fp8_linear)
    gr = grads(lambda a, b: a @ b)
    for a, b in zip(g8, gr):
        assert float((a - b).abs().max() / b.abs().max()) < 0.15


@pytest.mark.parametrize("which", ["tile", "block"])
def test_ste_forward_bits_unchanged_and_gradient_identity(which):
    g = _gen(("ste", which))
    shape = (3, 200, 136) if which == "block" else (4, 7, 300)
    a = g.standard_normal(shape).astype(np.float32)
    jfn = jmoe.ste_qdq_block if which == "block" else jmoe.ste_qdq_tile
    tfn = moe.ste_qdq_block if which == "block" else moe.ste_qdq_tile
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        t = torch.from_numpy(a).to(dt).requires_grad_(True)
        out = tfn(t)
        ref = np.asarray(jfn(jnp.asarray(a, jdt)).astype(jnp.float32))
        np.testing.assert_array_equal(out.detach().float().numpy(), ref)
        ct = torch.ones_like(out)
        (gin,) = torch.autograd.grad(out, (t,), ct)
        assert torch.equal(gin, ct)


# the backward's operands through fp8_gemm's caller-facing function (on
# the CPU: its plain version): a transposed, non-contiguous x2ᵀ; a plain
# tensor as the weight; a token count K that is no multiple of 128; K = 64
OPERANDS = {"dw_x2T_ragged_tokens": ((384, 200), True, (200, 256)),
            "dw_x2T_aligned": ((256, 128), True, (128, 384)),
            "dx_k64": ((96, 64), False, (64, 512)),
            "dx_wT": ((128, 384), False, (384, 256))}


@pytest.mark.parametrize("case", sorted(OPERANDS))
def test_operands_take_the_backward_shapes(case):
    (M, K), transposed, (Kw, N) = OPERANDS[case]
    g = _gen(("operands", case))
    a = torch.from_numpy(g.standard_normal(
        (K, M) if transposed else (M, K)).astype(np.float32))
    if transposed:
        a = a.t()
    assert a.is_contiguous() != transposed
    b = torch.from_numpy(g.standard_normal((Kw, N)).astype(np.float32))
    xq, xs, wq, ws = fp8_ops.operands(a, b)
    assert xq.shape[1] % 128 == 0 and wq.shape[0] == xq.shape[1]
    assert fp8_ops.k_contiguous(wq)
    got = fp8_ops.fp8_matmul(a, b)
    aq, as_ = fp8.quantize_tilewise(a)
    bq, bs = fp8.quantize_blockwise(b)
    ref = fp8.scaled_matmul_ref(aq, as_, bq, bs)
    jref = jfp8.scaled_matmul_ref(*jfp8.quantize_tilewise(
        jnp.asarray(a.numpy())), *jfp8.quantize_blockwise(
        jnp.asarray(b.numpy())))
    assert _rel(got, ref) <= TOL
    assert _rel(got, jref) <= TOL
