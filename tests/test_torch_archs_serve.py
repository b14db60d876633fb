"""PyTorch port: greedy streams of glm4-9b (32 heads over 2 KV heads at
published width; smoke: 4 over 2), qwen1.5-4b (MHA, QKV bias) and yi-34b
(56 over 8; smoke: 4 over 4) through ``ServeEngine`` equal to the JAX
engine's on the dense engine and on paged bf16 pages, on the default path
and the kernel path (harness: ``tests/_torch_archs.py``; fp8 pages and
chunked prefill: ``test_torch_archs_paged.py``). The kernel path sends
the prompts through ``flash_prefill`` and paged decode through
``paged_gqa_decode`` (their plain versions here), and nothing through the
MLA, MoE or FP8 ops.
"""
import pytest
import torch

import _torch_archs as h

ARCHS = ("glm4-9b", "qwen1.5-4b", "yi-34b")
MODES = ("dense", "paged-bf16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return {arch: h.weights(arch) for arch in ARCHS}


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_equal_jax_engine(weights, arch, mode, kernel_path):
    h.check_streams(arch, weights[arch], mode, kernel_path)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_reaches_the_gqa_ops(weights, arch, monkeypatch):
    calls = h.counted_ops(monkeypatch)
    eng = h.port_engine(arch, weights[arch][1], "paged-fp8", True)
    h.port_streams(eng)
    assert set(calls) == {"flash_prefill", "paged_gqa_decode"}
