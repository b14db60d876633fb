"""PyTorch port: qwen3-moe-30b-a3b (128 experts, softmax routing, top-8
from 4 of 8 groups; smoke: 8 experts, top-2 from 2 of 4) through
``ServeEngine``: greedy streams equal to the JAX engine's on the dense
engine, paged bf16 and fp8 pages and chunked prefill, on the default path
and the kernel path (harness: ``tests/_torch_archs.py``). Its routed
experts are bf16 (``fp8=False``): on the kernel path they reach
``moe_gemm`` in its bf16 format, never ``fp8_gemm``, and are stored as
plain tensors.
"""
import pytest
import torch

import _torch_archs as h
from repro_torch import bridge

ARCH = "qwen3-moe-30b-a3b"


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
    stored = bridge.expert_storage(eng.params)
    moe = eng.cfg.moe
    assert stored["e4m3"] == 0
    assert stored["plain"] == 3 * eng.cfg.num_layers * moe.num_experts


def test_kernel_path_reaches_moe_gemm_in_bf16(weights, monkeypatch):
    calls = h.counted_ops(monkeypatch)
    eng = h.port_engine(ARCH, weights[1], "paged-fp8", True)
    h.port_streams(eng)
    assert set(calls) == {"flash_prefill", "paged_gqa_decode", "moe_gemm"}
    # three grouped products a MoE layer and forward
    assert calls["moe_gemm"] % (3 * eng.cfg.num_layers) == 0
