"""PyTorch port on the card: each hand-written CUDA kernel against its plain
PyTorch version at the main path's shapes, and the serving engine through
all three kernels. Every test needs an NVIDIA GPU and nvcc (the kernels
have no CPU mode) and skips without one.

This file imports neither JAX nor the reference package, so it also runs
where JAX is not installed (the machine with the card):

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances, relative to the largest plain-version magnitude: fp32 outputs
2e-5 (the same exact products summed in another order), bf16 outputs
2^-7 (one rounding step).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core import fp8, paged
from repro_torch.kernels import registry
from repro_torch.kernels.fp8_gemm import ops as fp8_ops
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

FP32_TOL = 2e-5
BF16_TOL = 2 ** -7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", [(4, 16384, 7168), (512, 7168, 18432),
                                   (100, 200, 72)])
def test_fp8_gemm_kernel_matches_plain(card, shape):
    M, K, N = shape
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(M, K, generator=g, device=card, dtype=torch.bfloat16)
    w = torch.randn(K, N, generator=g, device=card) * 0.02
    before = fp8_ops.fp8_gemm.launches
    y = fp8_ops.fp8_matmul(x, w)
    assert fp8_ops.fp8_gemm.launches == before + 1
    xq, xs = fp8.quantize_tilewise(x)
    wq, ws = fp8.quantize_blockwise(w)
    assert _rel_err(y, fp8.scaled_matmul_ref(xq, xs, wq, ws)) <= FP32_TOL


@pytest.mark.parametrize("dims", [(256, 8, 7168, 2048), (256, 8, 2048, 7168),
                                  (3, 40, 72, 96)])
def test_moe_gemm_kernel_matches_plain(card, dims):
    E, C, D, F = dims
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(E, C, D, generator=g, device=card).bfloat16()
    w = (torch.randn(E, D, F, generator=g, device=card) * 0.02).bfloat16()
    before = moe_ops.grouped_matmul.launches
    y = moe_ops.grouped_matmul(x, w)
    assert moe_ops.grouped_matmul.launches == before + 1
    ref = torch.cat([moe_ops.grouped_matmul.run_plain(x[e:e + 1], w[e:e + 1])
                     for e in range(E)])
    assert _rel_err(y, ref) <= BF16_TOL


def test_moe_gemm_kernel_refuses_fp32(card):
    x = torch.ones(2, 16, 32, device=card)
    with pytest.raises(TypeError, match="bf16"):
        moe_ops.grouped_matmul(x, torch.ones(2, 32, 128, device=card))


@pytest.mark.parametrize("storage", ["fp8", "bf16"])
def test_paged_mla_decode_kernel_matches_plain(card, storage):
    B, H, R, Rr, page, pp = 4, 128, 512, 64, 8, 128
    P = B * pp
    g = torch.Generator(device=card).manual_seed(1)
    qa = torch.randn(B, H, R, generator=g, device=card)
    qr = torch.randn(B, H, Rr, generator=g, device=card)
    ckv = torch.randn(P + 1, page, R, generator=g, device=card)
    kr = torch.randn(P + 1, page, Rr, generator=g, device=card)
    if storage == "fp8":
        ckv, cs = paged.quantize_vecs(ckv)
        kr, ks = paged.quantize_vecs(kr)
        ckv, kr = ckv.view(torch.uint8), kr.view(torch.uint8)
    else:
        ckv, kr = ckv.bfloat16(), kr.bfloat16()
        cs = ks = torch.ones(P + 1, page, device=card)
    table = torch.randperm(P, generator=g, device=card).reshape(B, pp).int()
    qpos = torch.tensor([63, 299, 699, 1023], dtype=torch.int32, device=card)
    args = (qa, qr, ckv, kr, cs, ks, table, qpos)
    before = paged_ops.paged_mla_decode.launches
    out = paged_ops.paged_mla_decode(*args, scale=0.0722)
    assert paged_ops.paged_mla_decode.launches == before + 1
    ref = paged_ops.paged_mla_decode.run_plain(*args, scale=0.0722)
    assert _rel_err(out, ref) <= FP32_TOL


def test_engine_on_the_card_launches_every_kernel(card):
    cfg = dataclasses.replace(smoke_config(get_config("deepseek-v3-671b")),
                              dtype="bfloat16", param_dtype="bfloat16",
                              fp8_impl="pallas")
    eng = ServeEngine(cfg, slots=2, max_len=32, chunk=4, paged=True,
                      page_size=8, page_storage="fp8", attn_impl="pallas",
                      device=card)
    reqs = [Request(i, np.arange(4 + i), max_new=5) for i in range(3)]
    registry.reset_launch_counts()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    assert all(n > 0 for n in registry.launch_counts().values())
    assert eng.free_pages() == eng.pool_pages
