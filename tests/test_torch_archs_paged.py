"""PyTorch port: greedy streams of glm4-9b, qwen1.5-4b and yi-34b through
``ServeEngine`` on fp8 pages, whole-prompt and chunked (chunks of 8),
equal to the JAX engine's on the default path and the kernel path
(harness: ``tests/_torch_archs.py``; the dense engine and bf16 pages:
``test_torch_archs_serve.py``).
"""
import pytest
import torch

import _torch_archs as h

ARCHS = ("glm4-9b", "qwen1.5-4b", "yi-34b")
MODES = ("paged-fp8", "chunked")


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
