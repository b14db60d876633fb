"""PyTorch port: llama4-maverick's ``interleave:2`` layout — one segment
``pat`` of dense/MoE pairs, each pair's parameters and caches nested as
``{"dense", "moe"}`` — served through ``ServeEngine`` against the JAX
engine (smoke: 4 layers as 2 pairs, 8 experts top-1 plus the shared
expert): greedy streams equal on the dense engine, paged bf16 and fp8
pages and chunked prefill, on the default path and the kernel path
(harness: ``tests/_torch_archs.py``); on the kernel path each MoE block's
experts reach ``moe_gemm`` (bf16 format) three times a forward. The
nested pools, the tier, the dual decode, ``loss_dual`` and the A.11
refusals: ``test_torch_archs_pairs.py``.
"""
import pytest
import torch

import _torch_archs as h

ARCH = "llama4-maverick-400b-a17b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return h.weights(ARCH)


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("mode", sorted(h.MODES))
def test_streams_equal_jax_engine(weights, mode, kernel_path):
    eng = h.check_streams(ARCH, weights, mode, kernel_path)
    assert sorted(eng.cache["pat"]) == ["dense", "moe"]


def test_kernel_path_reaches_moe_gemm_in_bf16(weights, monkeypatch):
    calls = h.counted_ops(monkeypatch)
    eng = h.port_engine(ARCH, weights[1], "paged-fp8", True)
    h.port_streams(eng)
    assert set(calls) == {"flash_prefill", "paged_gqa_decode", "moe_gemm"}
    pairs = eng.cfg.num_layers // 2
    # attention in both blocks of a pair, the experts in the MoE block
    assert calls["paged_gqa_decode"] % (2 * pairs) == 0
    assert calls["moe_gemm"] % (3 * pairs) == 0
    assert calls["moe_gemm"] // 3 == calls["paged_gqa_decode"] // 2 + (
        calls["flash_prefill"] // 2)
