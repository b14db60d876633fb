"""PyTorch port: the decode chunk's static buffers and launch accounting,
on the CPU (``serve/graph.py``, ``kernels/registry.py``).

On the card the engine captures its decode chunk once as a CUDA graph and
replays it every tick, so the chunk must read and write the same buffers
each time: every cache leaf stays the tensor it was after a
``decode_loop`` (the MTP hidden included), and the engine's input buffer
keeps its address across ticks and admissions. The graph's launches are
counted as a capture's tally times its replays. Here, on the CPU, the
chunk runs eagerly: its streams equal the JAX engine's, and nothing is
captured. The graph itself runs in ``tests/test_torch_cuda.py``.
"""
import ctypes

import numpy as np
import pytest
import torch
from test_torch_serve import KW, _prompts, weights  # noqa: F401 (fixture)

from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.kernels import registry
from repro_torch.models.api import Model
from repro_torch.serve.engine import Request, ServeEngine
from _torch_threads import one_thread  # noqa: F401


# (arch, cache layout, MTP draft): the three served paths' layouts
LAYOUTS = {
    "dsv3-dense-mtp": ("deepseek-v3-671b", "dense", True),
    "dsv3-paged-fp8-mtp": ("deepseek-v3-671b", "fp8", True),
    "qwen-paged-fp8": ("qwen3-14b", "fp8", False),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_loop_keeps_every_cache_leaf(layout):
    """After a decode_loop every leaf of the cache dict (pools or rings,
    ``pos``, ``page_table``, ``mtp_h``, the MTP ring) is the same tensor
    at the same address, and the step's hidden landed in ``mtp_h``."""
    arch, storage, mtp = LAYOUTS[layout]
    cfg = tsmoke(tget(arch))
    model = Model(cfg, device="cpu")
    params = bridge.prepare_for_serving(model.init(0), cfg, inplace=True)
    B, T = 2, 32
    if storage == "dense":
        cache = model.init_cache(B, T)
    else:
        cache = model.init_paged_cache(B, T, 8, 2 * T // 8, storage)
        cache["page_table"].copy_(torch.arange(2 * T // 8).reshape(B, -1))
    before = {k: (v, v.data_ptr()) for k, v in _leaves(cache)}
    st = model.init_decode_state(B)
    st["active"][:] = True
    st["positions"].copy_(torch.tensor([3, 9]))
    st["tokens"].copy_(torch.tensor([5, 7]))
    st["left"][:] = 8
    _, _, out, _ = model.decode_loop(params, cache, st, 2, use_mtp=mtp)
    assert out is cache
    after = dict(_leaves(cache))
    assert after.keys() == before.keys()
    for k, (t, ptr) in before.items():
        assert after[k] is t and after[k].data_ptr() == ptr, k
    assert ("/mtp_h" in after) == mtp
    if mtp:
        assert after["/mtp_h"].abs().sum() > 0


@pytest.mark.parametrize("layout", ["dsv3-paged-fp8-mtp", "qwen-paged-fp8"])
def test_prefill_chunk_keeps_every_cache_leaf(layout):
    """The prefill chunk (``graph.PrefillChunk``, eager here) writes the
    pools and ``mtp_h`` in place: every leaf and its input buffer keep
    their addresses over two chunks of two slots, the slot operand picks
    the ``mtp_h`` row, and the page table is left to the engine."""
    from repro_torch.serve.graph import PrefillChunk
    arch, storage, _ = LAYOUTS[layout]
    cfg = tsmoke(tget(arch))
    model = Model(cfg, device="cpu")
    params = bridge.prepare_for_serving(model.init(0), cfg, inplace=True)
    B, T, page, C = 2, 32, 8, 8
    cache = model.init_paged_cache(B, T, page, 2 * T // page, storage)
    table = cache["page_table"].clone()
    before = {k: (v, v.data_ptr()) for k, v in _leaves(cache)}
    chunk = PrefillChunk(model, params, cache, C, T // page)
    ptr = chunk.input.data_ptr()
    rows = np.arange(2 * T // page, dtype=np.int32).reshape(B, -1)
    for start in (0, C):
        logits = chunk(np.arange(start + 1, start + C + 1), start, 13, 1,
                       rows[1])
        assert logits.shape == (1, 1, cfg.vocab_size)
    assert chunk.input.data_ptr() == ptr and chunk.calls == 2
    assert torch.equal(chunk.row, torch.from_numpy(rows[1]))
    after = dict(_leaves(cache))
    for k, (t, p) in before.items():
        assert after[k] is t and after[k].data_ptr() == p, k
    assert torch.equal(cache["page_table"], table)
    pool = next(iter(cache[model.segments[0].name].values()))
    assert pool[:, rows[1, :2]].any() and not pool[:, rows[0]].any()
    if cfg.mtp:
        assert cache["mtp_h"][1].any() and not cache["mtp_h"][0].any()


def _stub(rc: int):
    """A C entry that launches nothing and returns ``rc`` (the CUDA error
    code a kernel's entry returns)."""
    return ctypes.CFUNCTYPE(ctypes.c_int)(lambda: rc)


@pytest.mark.parametrize("replays", [0, 1, 3])
def test_tallied_launches_count_once_per_replay(replays):
    """Launches made inside a tally are not counted until the tally is
    added, once per replay; launches outside one count at once."""
    moe, fp8 = registry.get("moe_gemm"), registry.get("fp8_gemm")
    ok = _stub(0)
    registry.reset_launch_counts()
    moe.launch(ok)
    assert registry.launch_counts()["moe_gemm"] == 1
    with registry.tally() as t:
        moe.launch(ok)
        moe.launch(ok)
        fp8.launch(ok)
    assert t == {"moe_gemm": 2, "fp8_gemm": 1}
    assert registry.launch_counts()["moe_gemm"] == 1
    assert registry.launch_counts()["fp8_gemm"] == 0
    registry.add_launches(t, replays)
    counts = registry.launch_counts()
    assert counts["moe_gemm"] == 1 + 2 * replays
    assert counts["fp8_gemm"] == replays
    registry.reset_launch_counts()


def test_nested_tally_collects_only_its_own_launches():
    """The innermost open tally takes a launch, and a refused launch
    (non-zero return) raises and is counted nowhere."""
    moe = registry.get("moe_gemm")
    registry.reset_launch_counts()
    with registry.tally() as outer:
        moe.launch(_stub(0))
        with registry.tally() as inner:
            moe.launch(_stub(0))
            with pytest.raises(RuntimeError, match="error 7"):
                moe.launch(_stub(7))
        assert inner == {"moe_gemm": 1}
    assert outer == {"moe_gemm": 1}
    assert registry.launch_counts()["moe_gemm"] == 0


@pytest.mark.parametrize("paged", [True, False])
def test_engine_input_buffer_is_static_and_streams_equal_jax(weights,
                                                             paged):
    """Three requests on two slots (the third admits into a freed slot
    mid-run): the chunk's input buffer keeps its address every tick, the
    streams and MTP counts equal the JAX engine's, and nothing is captured
    on the CPU."""
    jp, npp = weights
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    kw = dict(KW, paged=paged, use_mtp=True)
    prompts = _prompts(cfg.vocab_size)
    budgets = [3, 9, 6]
    jeng = JServeEngine(cfg, params=jp, **kw)
    jreqs = [JRequest(i, p, max_new=n)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    with kernels.use_backend("ref"):
        for r in jreqs:
            jeng.submit(r)
        jeng.run_until_done()
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                      device="cpu", **kw)
    reqs = [Request(i, p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        eng.submit(r)
    buf = eng._decode.input
    ptr, first_tick, tick = buf.data_ptr(), {}, 0
    while eng.has_work():
        eng.step()
        assert eng._decode.input is buf and buf.data_ptr() == ptr
        for r in reqs:
            if r.out:
                first_tick.setdefault(r.rid, tick)
        tick += 1
    assert first_tick[2] > 0              # admitted into a freed slot
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert (eng.stats["drafts"], eng.stats["accepted_drafts"]) == (
        jeng.stats["drafts"], jeng.stats["accepted_drafts"])
    assert eng.trace_counts == {"decode": 0, "chunk": 0}


def test_cpu_engine_captures_nothing(weights):
    """``trace_counts["decode"]`` stays 0 on the CPU over many ticks."""
    _, npp = weights
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    eng = ServeEngine(tcfg, params=bridge.params_from_jax(npp),
                      device="cpu", **KW)
    eng.submit(Request(0, np.arange(5), max_new=12))
    ticks = 0
    while eng.has_work():
        eng.step()
        ticks += 1
    assert ticks >= 3
    assert eng.trace_counts == {"decode": 0, "chunk": 0}
    assert not eng._decode.graphed
