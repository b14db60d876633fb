"""PyTorch port: the analytic cost model (``repro_torch.launch.costs``)
against the reference's ``repro.launch.costs``: ``step_costs`` for all
eleven archs x each applicable ``SHAPES`` entry x ``remat`` in {full,
dots, none}, and ``cache_bytes``, with the bf16 cache and an fp8 one, at
rel 1e-12 (the same arithmetic); the paper's Table 2 (~250 GFLOP a token
for DeepSeek-V3) within 5%; and the counts calibrated against
``torch.utils.flop_counter.FlopCounterMode`` over the port's
``Model.loss`` and its backward on a 2-layer smoke glm4-9b, inside the
reference's (0.2, 2.0) band. The card's constants are the H100 SXM's
data-sheet peaks.
"""
import dataclasses
import math

import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.launch import costs as jcosts
from repro_torch.configs.base import (SHAPES, ShapeCfg, get_config,
                                      list_archs, shape_applicable,
                                      smoke_config)
from repro_torch.launch import costs
from repro_torch.models.api import Model

FP8_CACHE = dict(cache_dtype="float8_e4m3fn")
CASES = [(arch, shape, remat)
         for arch in sorted(jbase.list_archs())
         for shape in jbase.SHAPES
         for remat in ("full", "dots", "none")
         if jbase.shape_applicable(jbase.get_config(arch),
                                   jbase.SHAPES[shape])[0]]


def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


def test_the_shape_cells_are_the_reference_ones():
    assert list_archs() == jbase.list_archs()
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    for arch in list_archs():
        for name, shape in SHAPES.items():
            assert shape_applicable(get_config(arch), shape) == \
                jbase.shape_applicable(jbase.get_config(arch),
                                       jbase.SHAPES[name])


@pytest.mark.parametrize("arch,shape,remat", CASES)
def test_step_costs_equal_the_reference(arch, shape, remat):
    for kw in ({}, FP8_CACHE):
        got = costs.step_costs(get_config(arch, **kw), SHAPES[shape],
                               remat=remat)
        want = jcosts.step_costs(jbase.get_config(arch, **kw),
                                 jbase.SHAPES[shape], remat=remat)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a == b) if isinstance(a, str) else _close(a, b), \
                (f.name, a, b)


@pytest.mark.parametrize("arch", sorted(jbase.list_archs()))
def test_cache_bytes_equal_the_reference(arch):
    for kw in ({}, FP8_CACHE):
        for batch, context in ((1, 1), (4, 1000), (128, 32768)):
            assert _close(
                costs.cache_bytes(get_config(arch, **kw), batch, context),
                jcosts.cache_bytes(jbase.get_config(arch, **kw), batch,
                                   context))


def test_fp8_cache_halves_cache_bytes():
    cfg = get_config("yi-34b")
    ratio = costs.cache_bytes(cfg, 128, 32768) / costs.cache_bytes(
        dataclasses.replace(cfg, **FP8_CACHE), 128, 32768)
    assert abs(ratio - 2.0) < 0.01


def test_decode_weight_coverage():
    """MoE decode weight traffic: B=1 reads ~active only; B=128 reads
    ~all experts (the decode memory wall)."""
    cfg = get_config("deepseek-v3-671b")
    big = costs.step_costs(cfg, SHAPES["decode_32k"])
    small = costs.step_costs(cfg, ShapeCfg("d1", 32768, 1, "decode"))
    assert big.hbm_bytes / big.tokens < small.hbm_bytes / small.tokens
    assert big.hbm_bytes > 1.0e12


def test_cost_model_vs_paper_table2():
    c = costs.step_costs(get_config("deepseek-v3-671b"), SHAPES["train_4k"],
                         remat="none")
    gflops_tok = c.flops_fwd * 3 / c.tokens / 1e9
    assert abs(gflops_tok - 250) / 250 < 0.05


def test_h100_constants():
    assert (costs.PEAK_FLOPS, costs.PEAK_FLOPS_FP8, costs.PEAK_FLOPS_FP32,
            costs.HBM_BW, costs.ICI_BW) == (989e12, 1979e12, 67e12, 3.35e12,
                                            450e9)


def test_cost_model_calibration_flop_counter():
    """The analytic train FLOPs against the FLOPs torch counts in the
    port's loss and its backward on a 2-layer smoke glm4-9b."""
    cfg = dataclasses.replace(smoke_config(get_config("glm4-9b")),
                              num_layers=2, fp8=False)
    model = Model(cfg, device="cpu")
    leaves, spec = pytree.tree_flatten(model.init(0))
    leaves = [t.requires_grad_(True) for t in leaves]
    B, S = 2, 128
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        loss, _ = model.loss(pytree.tree_unflatten(leaves, spec), batch)
        torch.autograd.grad(loss, leaves)
    c = costs.step_costs(cfg, ShapeCfg("cal", S, B, "train"), remat="none")
    ratio = fc.get_total_flops() / c.flops_total
    assert 0.2 < ratio < 2.0, (fc.get_total_flops(), c.flops_total)
