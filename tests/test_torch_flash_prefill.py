"""PyTorch port: the flash_prefill kernel op against the JAX reference
(``repro.kernels.flash_attention``), and the kernel table's pointers into
the JAX package.

Inputs come from numpy seeds and are rounded to the operand dtype the same
way on both sides. The JAX op runs on the CPU's default backend (the
Pallas kernel in interpret mode). Tolerances are relative to the largest
reference magnitude: 1e-5 for fp32 operands, 2e-2 for bf16 (the
reference's own parity tolerance for this op).
"""
import pathlib
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jflash_ops
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (B, S, T, H, KV, hd), dtype, causal — the reference's flash_prefill
# sweep (tests/test_kernel_registry.py PARITY_CASES)
PARITY = [((2, 16, 16, 4, 2, 32), "float32", True),
          ((2, 16, 16, 4, 2, 32), "bfloat16", True),
          ((1, 8, 8, 4, 4, 16), "float32", True),
          ((2, 32, 32, 8, 2, 64), "float32", True),
          ((1, 128, 128, 4, 2, 32), "float32", True),
          ((2, 16, 16, 2, 1, 32), "float32", False)]


def _inputs(dims, dtype):
    B, S, T, H, KV, hd = dims
    g = np.random.default_rng(zlib.crc32(repr((dims, dtype)).encode()))
    q = g.standard_normal((B, S, H, hd)).astype(np.float32)
    k = g.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = g.standard_normal((B, T, KV, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    # ragged rows: row b keeps T - b real keys, pads carry k_pos = -1
    lens = T - np.arange(B)
    kp = np.where(np.arange(T)[None, :] < lens[:, None],
                  np.arange(T, dtype=np.int32)[None, :], -1).astype(np.int32)
    return q, k, v, qp, kp


def _both(arrays, dtype):
    """The same values as torch tensors and JAX arrays of ``dtype``."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    q, k, v, qp, kp = arrays
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    j = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    t += [torch.from_numpy(qp), torch.from_numpy(kp)]
    j += [jnp.asarray(qp), jnp.asarray(kp)]
    return t, j


def _close(a, b, rtol):
    a = a.detach().float().numpy()
    b = np.asarray(jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= rtol * float(np.abs(b).max()), err


@pytest.mark.parametrize("dims,dtype,causal", PARITY)
def test_plain_matches_jax_interpret_kernel(dims, dtype, causal):
    t, j = _both(_inputs(dims, dtype), dtype)
    ref = jflash_ops.flash_prefill(*j, causal=causal, scale=0.13)
    ours = flash_ops.flash_prefill(*t, causal=causal, scale=0.13)
    assert ours.dtype == torch.float32
    _close(ours, ref, TOL[dtype])


def test_rows_without_a_valid_key_are_zero():
    t, j = _both(_inputs((1, 16, 16, 2, 1, 32), "float32"), "float32")
    t[4] = torch.where(t[4] >= 6, t[4], -1)          # keys 0..5 are pads
    j[4] = jnp.asarray(t[4].numpy())
    ours = flash_ops.flash_prefill(*t, causal=True, scale=0.2)
    ref = jflash_ops.flash_prefill(*j, causal=True, scale=0.2)
    assert bool((ours[0, :6] == 0).all())
    _close(ours, ref, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_scores_kernel_branch_matches_direct(dtype):
    """``attention_scores(impl="pallas")`` reaches the op, and on causal
    prefill with no pads it computes what the direct path computes."""
    dims = (1, 24, 24, 6, 2, 32)
    (q, k, v, qp, _), _ = _both(_inputs(dims, dtype), dtype)
    registry.reset_launch_counts()
    a = layers.attention_scores(q, k, v, causal=True, q_pos=qp, k_pos=qp,
                                impl="pallas")
    b = layers.attention_scores(q, k, v, causal=True, q_pos=qp, k_pos=qp)
    assert a.dtype == b.dtype == getattr(torch, dtype)
    err = float((a.float() - b.float()).abs().max())
    assert err <= TOL[dtype] * float(b.float().abs().max())
    assert registry.launch_counts()["flash_prefill"] == 0   # CPU: plain


def test_cpu_tensor_runs_plain_and_counts_nothing():
    t, _ = _both(_inputs((1, 8, 8, 4, 4, 16), "float32"), "float32")
    registry.reset_launch_counts()
    flash_ops.flash_prefill(*t, causal=True, scale=0.25)
    assert registry.launch_counts()["flash_prefill"] == 0


@pytest.mark.parametrize("name", ["fp8_gemm", "moe_gemm", "paged_mla_decode",
                                  "paged_gqa_decode", "flash_prefill",
                                  "mla_decode", "logfmt_encode",
                                  "logfmt_decode"])
def test_replaces_names_the_tpu_kernel_function(name):
    """Each op's ``replaces`` (file:line function) points at the JAX
    package's Pallas kernel function, as the PERF.md table cites it."""
    path, fn = registry.get(name).replaces.split()
    file, line = path.rsplit(":", 1)
    src = (ROOT / file).read_text().splitlines()
    assert re.match(rf"\s*def {fn}\(", src[int(line) - 1]), src[int(line) - 1]
    assert "pl.pallas_call" in (ROOT / file).read_text()
