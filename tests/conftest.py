"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see 1 device (the dry-run sets its own 512-device flag in its own
process). Multi-device tests spawn subprocesses (see test_distributed.py).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import jax.numpy as jnp
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def assert_finite(tree, name=""):
    for leaf in jax.tree.leaves(tree):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            assert bool(jnp.isfinite(leaf).all()), f"non-finite in {name}"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skipped where there is none")
