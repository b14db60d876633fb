"""PyTorch port: the LogFMT codec (``repro_torch.core.logfmt``) and its
kernel ops (``repro_torch.kernels.logfmt.ops``) against the JAX reference:
``repro.core.logfmt`` and the Pallas kernels through
``repro.kernels.logfmt.ops``, which run in interpret mode on the CPU (the
registry's default backend there).

Inputs come from numpy seeds. Tolerances are the reference's own
(``tests/test_kernel_registry.py``): codes may differ by one level on
under 0.1% of entries (a last-ulp difference of log/exp between two
libms flips a tie), mn within rtol 1e-5 / atol 1e-6, step within rtol
1e-5 / atol 1e-5; decoded values within rtol 1e-4 / atol 1e-5. The codec
cases are the ports of ``tests/test_logfmt.py``.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import logfmt as jlogfmt
from repro.kernels.logfmt import ops as jops
from repro_torch.core import logfmt
from repro_torch.kernels import registry
from repro_torch.kernels.logfmt import ops
from repro_torch.kernels.logfmt.edge import edge_tiles
from _torch_threads import one_thread  # noqa: F401


def _gen(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return np.asarray(t)


def _codes_close(got, ref):
    """``tests/test_kernel_registry.py:_logfmt_codes_close``."""
    (gc, gmn, gstep), (rc, rmn, rstep) = got, ref
    assert _np(gc).dtype == _np(rc).dtype, (_np(gc).dtype, _np(rc).dtype)
    assert _np(gc).shape == _np(rc).shape
    diff = _np(gc).astype(np.int32) - _np(rc).astype(np.int32)
    mismatch = diff != 0
    assert mismatch.mean() < 1e-3, mismatch.mean()
    assert np.abs(diff[mismatch]).max(initial=0) <= 1
    np.testing.assert_allclose(_np(gmn), _np(rmn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(gstep), _np(rstep), rtol=1e-5, atol=1e-5)


def _encode_input(shape):
    """The reference's encode parity input: normal * exp(normal), with
    three exact zeros at the start of the first row."""
    g = _gen(("encode", shape))
    x = (g.standard_normal(shape) * np.exp(g.standard_normal(shape)))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[0, :3] = 0.0
    return x


# the reference's PARITY_CASES (tests/test_kernel_registry.py)
ENCODE_CASES = [((8, 128), 8), ((64, 256), 10), ((128, 512), 8),
                ((100, 384), 8)]
DECODE_CASES = [((32, 256), 8), ((8, 128), 10), ((100, 384), 8)]


@pytest.mark.parametrize("shape,n_bits", ENCODE_CASES)
def test_encode_matches_jax_codec_and_pallas_kernel(shape, n_bits):
    x = _encode_input(shape)
    ours = ops.logfmt_encode(torch.from_numpy(x), n_bits=n_bits)
    assert ours[0].dtype == (torch.uint8 if n_bits <= 8 else torch.uint16)
    _codes_close(ours, jlogfmt.encode(jnp.asarray(x), n_bits))
    _codes_close(ours, jops.encode(jnp.asarray(x), n_bits=n_bits))
    # the zeros encode as code 0
    assert (ours[0].reshape(-1, shape[-1])[0, :3] == 0).all()


@pytest.mark.parametrize("n_bits", [2, 3, 8, 10, 16])
def test_edge_tiles_match_jax_codec_and_pallas_kernel(n_bits):
    """One tile per row (``kernels/logfmt/edge.py``): equal magnitudes, a
    single nonzero, zeros, a range past the 2^32 clamp, subnormals (alone
    in a wide tile, only, under one normal value), normals near 2^-126,
    ±inf, NaN, a range of 2^-23 and of 1/64. The reference's platforms
    compute without subnormals: a subnormal input gets code 0 and no sign
    bit and stays out of its tile's range, and a grid point or difference
    below 2^-126 is zero.

    Codes equal ``repro.core.logfmt``'s and the Pallas kernel's (at 16
    bits within one level on under 0.1%, the tie flips another libm's
    log/exp may cause), but for the Pallas kernel's on the tile near
    2^-126, where its step, from its own division, is one ulp off the
    codec's and flips a tie at 8 bits; mn and step within the codec's
    tolerances."""
    x, names = edge_tiles()
    ours = ops.logfmt_encode(torch.from_numpy(x), n_bits=n_bits)
    codec = jlogfmt.encode(jnp.asarray(x), n_bits)
    pallas = jops.encode(jnp.asarray(x), n_bits=n_bits)
    _codes_close(ours, codec)
    _codes_close(ours, pallas)
    if n_bits < 16:
        np.testing.assert_array_equal(_np(ours[0]), _np(codec[0]))
        rows = [i for i, n in enumerate(names) if n != "near the least normal"]
        np.testing.assert_array_equal(_np(ours[0])[rows],
                                      _np(pallas[0])[rows])
    codes = dict(zip(names, _np(ours[0]).astype(np.int64)))
    assert (codes["subnormals only"] == 0).all()
    assert codes["lone subnormal"][0] == 0
    assert codes["normal among negative subnormals"].tolist() == (
        [1] + [0] * 127)
    assert (codes["zeros"] == 0).all()


def test_bf16_edge_tiles_match_jax_codec():
    """bf16 inputs go through the same rule after widening to fp32: a bf16
    subnormal counts as zero."""
    x, _ = edge_tiles()
    xb = torch.from_numpy(x).bfloat16()
    ours = ops.logfmt_encode(xb, n_bits=8)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    ref = jlogfmt.encode(jx, 8)
    _codes_close(ours, ref)
    np.testing.assert_array_equal(_np(ours[0]), _np(ref[0]))


def _decode_inputs(shape, n_bits):
    x = (_gen(("decode", shape)).standard_normal(shape) * 5).astype(
        np.float32)
    c, mn, step = jlogfmt.encode(jnp.asarray(x), n_bits)
    return (c, mn, step), tuple(torch.from_numpy(np.array(a))
                                for a in (c, mn, step))


@pytest.mark.parametrize("shape,n_bits", DECODE_CASES)
def test_decode_matches_jax_codec_and_pallas_kernel(shape, n_bits):
    ref, ours = _decode_inputs(shape, n_bits)
    y = ops.logfmt_decode(*ours, n_bits=n_bits, dtype=torch.float32)
    assert y.dtype == torch.float32 and y.shape == shape
    for r in (jlogfmt.decode(*ref, n_bits, dtype=jnp.float32),
              jops.decode(*ref, n_bits=n_bits, dtype=jnp.float32)):
        np.testing.assert_allclose(y.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_decode_default_dtype_is_bf16_like_the_reference():
    ref, ours = _decode_inputs((8, 256), 8)
    y = ops.logfmt_decode(*ours)
    r = jlogfmt.decode(*ref)
    assert y.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
    # one bf16 rounding step of the fp32 values
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(r.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-5)


def test_ops_reshape_a_batched_input():
    """(B, S, D) goes through the ops' 2-D reshape and back, as the JAX
    op's does."""
    x = _encode_input((2, 3, 256))
    ours = ops.logfmt_encode(torch.from_numpy(x), n_bits=8)
    assert ours[0].shape == (2, 3, 256)
    assert ours[1].shape == ours[2].shape == (2, 3, 2)
    ref = jops.encode(jnp.asarray(x), n_bits=8)
    _codes_close(ours, ref)
    y = ops.logfmt_decode(*ours, n_bits=8, dtype=torch.float32)
    jy = jops.decode(*ref, n_bits=8, dtype=jnp.float32)
    assert y.shape == (2, 3, 256)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)


def test_cpu_tensor_runs_plain_and_counts_no_launch():
    x = torch.from_numpy(_encode_input((8, 128)))
    registry.reset_launch_counts()
    c, mn, step = ops.logfmt_encode(x, n_bits=8)
    ops.logfmt_decode(c, mn, step, n_bits=8)
    counts = registry.launch_counts()
    assert counts["logfmt_encode"] == counts["logfmt_decode"] == 0


@pytest.mark.parametrize("which", ["encode", "decode"])
def test_feature_dim_not_a_multiple_of_the_tile_raises(which):
    x = torch.ones(4, 200)
    with pytest.raises(ValueError, match="multiple of 128"):
        if which == "encode":
            ops.logfmt_encode(x, n_bits=8)
        else:
            ops.logfmt_decode(x.to(torch.uint8), torch.zeros(4, 2),
                              torch.ones(4, 2), n_bits=8)


def test_more_than_16_bits_raises_like_the_reference():
    with pytest.raises(ValueError, match="<=16 bits"):
        jlogfmt.encode(jnp.ones((1, 128)), 17)
    with pytest.raises(ValueError, match="<=16 bits"):
        logfmt.encode(torch.ones(1, 128), 17)


# --- the codec cases of tests/test_logfmt.py, each also against JAX ------


def _qdq_both(x, n_bits):
    ours = logfmt.qdq(torch.from_numpy(x), n_bits).numpy()
    ref = np.asarray(jlogfmt.qdq(jnp.asarray(x), n_bits))
    return ours, ref


def test_roundtrip_relative_error_8bit():
    g = _gen("roundtrip")
    x = (g.standard_normal((32, 256))
         * np.exp(g.standard_normal((32, 256)))).astype(np.float32)
    y, ref = _qdq_both(x, 8)
    rel = np.abs(x - y) / np.maximum(np.abs(x), 1e-12)
    assert float(rel.max()) < 0.12         # 127 log-levels across the range
    assert (np.abs(y - ref) > 1e-5 * np.abs(ref).max()).mean() < 1e-3


def test_more_bits_monotone():
    x = (_gen("monotone").standard_normal((16, 128)) * 3.7).astype(np.float32)
    errs = []
    for n in (6, 8, 10, 12):
        y, ref = _qdq_both(x, n)
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-6)
        errs.append(float(np.abs(x - y).max()))
    assert errs == sorted(errs, reverse=True)


def test_zeros_and_signs():
    x = np.array([[0.0, -1.5, 2.5, -0.01] + [1.0] * 124], np.float32)
    y, ref = _qdq_both(x, 8)
    assert y[0, 0] == 0.0
    assert y[0, 1] < 0 and y[0, 2] > 0 and y[0, 3] < 0
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-7)


def test_min_max_codes():
    """min encodes as code 1, max as the top code, and the max decodes to
    itself."""
    vals = np.array([[0.001, 1000.0] + [1.0] * 126], np.float32)
    c, mn, step = logfmt.encode(torch.from_numpy(vals), 8)
    assert int(c[0, 0]) == 1 and int(c[0, 1]) == 127
    y = logfmt.decode(c, mn, step, 8, dtype=torch.float32)
    np.testing.assert_allclose(float(y[0, 1]), 1000.0, rtol=1e-4)
    jc, _, _ = jlogfmt.encode(jnp.asarray(vals), 8)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_range_clamp():
    """min is clamped to max - log(2^32) (E5-like range)."""
    x = np.array([[1e30, 1e-30] + [1.0] * 126], np.float32)
    y, ref = _qdq_both(x, 8)
    assert np.isfinite(y).all()
    # the tiny value is pulled up to the clamped range bottom
    assert float(y[0, 1]) >= 1e30 / 2.0 ** 33
    np.testing.assert_allclose(y, ref, rtol=1e-5)


@pytest.mark.parametrize("n_bits", range(6, 13))
def test_qdq_idempotent(n_bits):
    """QDQ is idempotent: grid points map to themselves."""
    x = np.random.RandomState(n_bits).randn(4, 128).astype(np.float32)
    y1 = logfmt.qdq(torch.from_numpy(x), n_bits)
    y2 = logfmt.qdq(y1, n_bits)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-6)
    _, ref = _qdq_both(x, n_bits)
    np.testing.assert_allclose(y1.numpy(), ref, rtol=1e-4, atol=1e-6)


def test_wire_cost():
    assert logfmt.compressed_bits_per_element(8) == 8.5
    assert logfmt.compressed_bits_per_element(10) == 10.5
