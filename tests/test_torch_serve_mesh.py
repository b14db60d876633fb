"""PyTorch port: mesh-sharded serving, ``ServeEngine(ctx=ParallelCtx(
mesh=...))``, against the JAX reference's parity contract
(``tests/test_serve_distributed.py``, docs/serving.md §5).

One spawn of 8 gloo ranks on the CPU (rank body
``tests/_torch_serve_mesh.py``, no JAX) serves every scenario of the
reference's parity classes in turn on mesh (2, 4), on weights bridged
from the JAX ``Model.init``; the expected streams come from the JAX
single-device engine, run here while the ranks serve:

* dense GQA (qwen3-14b smoke): streams exact;
* GQA with 6 query and 2 KV heads (qwen3-14b smoke), which do not split
  over the 4 model columns, so the attention runs replicated
  (``sharding.whole_heads``), dense ring and paged bf16: streams exact
  against the JAX single-device engine;
* MoE (DeepSeek-V3 smoke) at the fp32 wire, ``ep_flat`` and
  ``ep_dedup``: exact;
* the FP8 wire: at least 0.9 of tokens matched, every token a valid id;
* MTP under the mesh: streams, ``drafts`` and ``accepted_drafts`` equal;
* paged bf16 GQA: exact; paged fp8 GQA against the JAX engine's paged
  fp8 streams, exact too (each token's FP8 scale covers its whole (KV,
  hd) entry: the model group's max under the KV-head cut);
* paged bf16 MLA against the sharded dense engine: at least 0.9;
* paged fp8 DeepSeek-V3 on the kernel path's plain versions (the card's
  path: ``fp8_impl``/``attn_impl`` "pallas", FP8 wire) against the port's
  single-device engine of the same options: at least 0.9;
* dual-microbatch decode (``decode_overlap=True``, ``ep_flat`` and
  ``ep_dedup`` at the fp32 wire): streams exact; per MoE layer and decode
  step exactly twice the single path's all-to-alls, their bytes in [1x,
  2x] of its and equal to ``decode_alltoall_bytes()``, and half B's
  attention issued between half A's dispatch issue and its wait
  (``collectives.record()``; the reference's ``TestDecodeOverlap``);
* on the (pod, data, model) mesh (2, 2, 2), the slots cut over the pair
  ``("pod", "data")``: dense qwen3-14b exact; DeepSeek-V3 (FP8 GEMMs
  off) on the dense engine with ``ep_ftp`` (the expert FF cut over
  ``"data"``, each position's tokens gathered over the pair) exact
  against the JAX single-device engine of the same config; paged fp8
  DeepSeek-V3 on the card's path at least 0.9 of its single device;
* chunked prefill under the mesh (chunks of 8, three prompts behind one
  16-token prefix): qwen3-14b paged bf16 and fp8, streams and
  ``prefix_stats()`` exact; a priority-5 arrival preempting a chunked
  resident, streams exact; DeepSeek-V3 paged bf16 at least 0.9 of the
  JAX engine's tokens, its kernel path (fp8 pages, FP8 wire) at least
  0.9 of the port's single device;
* the host page tier under the mesh (``tests/test_torch_tier.py``'s
  oversubscribed bench, 10 requests) at (2, 4) and (2, 2, 2): streams,
  ``tier_stats()``, ``pool_stats()``, ``prefix_stats()`` and ``stats``
  but ``dispatches`` exactly the JAX engine's; a byte of the host copy
  flipped on one rank only: every rank degrades the same request, the
  summary exactly JAX's ``_crc_corruption``; the slot-resident MTP rows
  gathered from the data row that owns the slot;
* planted faults that the contracts must reject: a fetch installing the
  first model column's KV heads on every rank, and a chunk writing the
  next column's K/V heads into this rank's pool;
* cross-mesh disaggregation (``TestCrossMeshDisagg``): prefill on (2, 4)
  over the 8 ranks, decode on (1, 4) over ranks 0-3, ``ep_flat``, fp32
  wire: dense streams exact, paged bf16 at least 0.9, and the paged
  handoff under the dense one; and qwen3-14b, whose K/V heads both meshes
  cut, dense streams exact.

On every scenario: every rank's host mirrors and streams are identical
(one CRC per rank, with the scheduler and tier figures of the chunked and
tiered runs), the decode chunk ran eagerly (``trace_counts["decode"] ==
0``; the prefill chunk too, ``"chunk"``), no page leaked, and the pools
are byte-equal across the data rows. A stream the reference asserts exact that parts in the
port is accepted only where the top-2 logit gap at its first differing
token is under 1e-5 of the logit scale (a reordered sum); the gap is
printed. Unmeshed contexts and ``decode_overlap``'s constructor checks
run in process. The module takes 100-140 s alone (the ranks and the
JAX engines side by side), about 290 s in a six-worker suite run.
"""
import json
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

import _torch_serve_mesh as body
from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models.api import Model
from repro_torch.parallel.context import ParallelCtx
from repro_torch.serve.engine import ServeEngine

WORLD = 8
PARTING_GAP = 1e-5


def _jax_configs():
    import dataclasses
    moe = smoke_config(get_config("deepseek-v3-671b"))
    moe = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, capacity_factor=8.0))
    qwen = smoke_config(get_config("qwen3-14b"))
    return {"qwen": qwen, "moe": moe,
            "qwen_heads6": dataclasses.replace(qwen, **body.HEADS6),
            "moe_nofp8": dataclasses.replace(moe, fp8=False)}


# configs served on another config's weights
SAME_WEIGHTS = {"moe_nofp8": "moe"}


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_drive(cfg, params, name, storage="bf16"):
    """A scheduler workload of the rank body (``body.drive``) on the JAX
    single-device engine: its summary (``body.summary``)."""
    from repro import kernels
    from repro.serve import tier as jtier
    kw = dict(body.CHUNKED, page_storage=storage)
    kw.update(body.drive_kw(name, jtier))

    def flip(payload):
        jax.tree.leaves(payload)[0].view(np.uint8).reshape(-1)[0] ^= 0xFF

    with kernels.use_backend("ref"):
        eng = JServeEngine(cfg, params=params, seed=0, chunk=4, **kw)
        reqs = body.drive(eng, JRequest, name, cfg.vocab_size, flip)
    assert all(r.done for r in reqs)
    return body.summary(eng, reqs)


def _jax_stream(cfg, params, **kw):
    eng = JServeEngine(cfg, params=params, slots=4, max_len=32, seed=0,
                       chunk=4, **kw)
    reqs = [JRequest(i, p, max_new=6)
            for i, p in enumerate(body.prompts_for(cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs], (eng.stats["drafts"],
                                         eng.stats["accepted_drafts"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh")
    cfgs = _jax_configs()
    params = {k: JModel(c).init(jax.random.PRNGKey(0))
              for k, c in cfgs.items() if k not in SAME_WEIGHTS}
    params.update({k: params[v] for k, v in SAME_WEIGHTS.items()})
    np_params = {k: jax.tree.map(np.asarray, v) for k, v in params.items()}
    flat = {}
    for k, v in np_params.items():
        if k not in SAME_WEIGHTS:
            _flatten(v, k + "/", flat)
    np.savez(d / "weights.npz", **flat)
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=body.run_rank,
                         args=(r, WORLD, str(d / "store"), str(d)))
             for r in range(WORLD)]
    for p in ranks:
        p.start()
    ref = {"qwen": _jax_stream(cfgs["qwen"], params["qwen"]),
           "qwen_fp8": _jax_stream(cfgs["qwen"], params["qwen"], paged=True,
                                   page_size=8, page_storage="fp8"),
           "moe": _jax_stream(cfgs["moe"], params["moe"]),
           "mtp": _jax_stream(cfgs["moe"], params["moe"], use_mtp=True),
           "qwen_heads6": _jax_stream(cfgs["qwen_heads6"],
                                      params["qwen_heads6"]),
           "moe_nofp8": _jax_stream(cfgs["moe_nofp8"], params["moe"]),
           "qwen_shared": _jax_drive(cfgs["qwen"], params["qwen"], "shared"),
           "qwen_shared_fp8": _jax_drive(cfgs["qwen"], params["qwen"],
                                         "shared", "fp8"),
           "qwen_preempt": _jax_drive(cfgs["qwen"], params["qwen"],
                                      "preempt"),
           "moe_shared": _jax_drive(cfgs["moe"], params["moe"], "shared"),
           "qwen_tier": _jax_drive(cfgs["qwen"], params["qwen"], "tier"),
           "qwen_tier_crc": _jax_drive(cfgs["qwen"], params["qwen"],
                                       "tier_crc")}
    for p in ranks:
        # the ranks serve 31 scenarios: ~100 s alone, ~290 s of a
        # six-worker suite run on an 8-core host
        p.join(timeout=600)
    codes = [p.exitcode for p in ranks]
    for p in ranks:
        if p.is_alive():
            p.kill()
    assert codes == [0] * WORLD, codes
    ours = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return ref, ours, np_params


def _streams(ours, name):
    return [[int(t) for t in row if t >= 0] for row in ours[0][name]]


def _match_frac(a, b):
    toks = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in toks) / len(toks)


def _top2_gap(model, np_params, prompt, prefix):
    """Top-2 logit gap over max|logit| of the port's single-device model
    after ``prompt + prefix`` (where a stream parted)."""
    tcfg = body.configs()[model]
    m = Model(tcfg, device="cpu")
    p = bridge.prepare_for_serving(bridge.params_from_jax(np_params[model]),
                                   tcfg)
    toks = np.concatenate([prompt, np.asarray(prefix, np.int64)])[None]
    logits, _ = m.prefill(p, {"tokens": torch.as_tensor(toks)})
    top = logits[0, -1].float().topk(2).values
    return float((top[0] - top[1]) / logits.abs().max())


def _exact_or_bounded_parting(ours_s, ref_s, model, np_params):
    if ours_s == ref_s:
        return
    prompts = body.prompts_for(512)
    for i, (a, b) in enumerate(zip(ours_s, ref_s)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        gap = _top2_gap(model, np_params, prompts[i], b[:j])
        print(f"request {i} parts at token {j}: top-2 gap {gap:.3e} of "
              "the logit scale")
        assert gap < PARTING_GAP, (i, j, gap, a, b)


@pytest.mark.parametrize("name,model,ref_key", [
    ("gqa_dense", "qwen", "qwen"), ("gqa_paged", "qwen", "qwen"),
    ("gqa_paged_fp8", "qwen", "qwen_fp8"),
    ("ep_flat", "moe", "moe"), ("ep_dedup", "moe", "moe"),
    ("ep_flat_overlap", "moe", "moe"), ("ep_dedup_overlap", "moe", "moe"),
    ("gqa_heads_whole", "qwen_heads6", "qwen_heads6"),
    ("gqa_heads_whole_paged", "qwen_heads6", "qwen_heads6"),
    ("pod_gqa_dense", "qwen", "qwen"), ("pod_ftp", "moe_nofp8", "moe_nofp8")])
def test_streams_exact_like_the_reference(run, name, model, ref_key):
    ref, ours, np_params = run
    _exact_or_bounded_parting(_streams(ours, name), ref[ref_key][0], model,
                              np_params)


def test_fp8_wire_within_documented_tolerance(run):
    ref, ours, _ = run
    s = _streams(ours, "fp8_wire")
    mf = _match_frac(ref["moe"][0], s)
    print("fp8 wire matched", mf)
    assert mf >= 0.9, (mf, s)
    assert all(0 <= t < 512 for row in s for t in row)


def test_mtp_drafts_under_mesh(run):
    ref, ours, np_params = run
    streams, counts = ref["mtp"]
    _exact_or_bounded_parting(_streams(ours, "mtp"), streams, "moe",
                              np_params)
    for r in range(WORLD):
        assert tuple(ours[r]["mtp:mtp"]) == counts, (r, counts)
    assert counts[0] > 0


@pytest.mark.parametrize("name,against", [
    ("mla_paged", "ep_flat"), ("card_path", "card_path_single"),
    ("pod_card_path", "card_path_single"),
    ("card_path_chunked", "card_path_chunked_single")])
def test_paged_mla_within_documented_tolerance(run, name, against):
    _, ours, _ = run
    mf = _match_frac(_streams(ours, against), _streams(ours, name))
    print(name, "matched", mf)
    assert mf >= 0.9, mf


@pytest.mark.parametrize("name", [n for n, (_, c, _) in
                                  body.SCENARIOS.items()
                                  if c is not None and n not in body.DISAGG])
def test_every_rank_holds_the_same_mirrors_and_streams(run, name):
    _, ours, _ = run
    assert len({int(o[name + ":mirrors"][0]) for o in ours}) == 1
    for o in ours[1:]:
        np.testing.assert_array_equal(o[name], ours[0][name])


@pytest.mark.parametrize("name", [n for n, (_, c, e) in
                                  body.SCENARIOS.items()
                                  if c is not None and e.get("paged")
                                  and n not in body.DISAGG])
def test_pools_byte_equal_across_data_rows(run, name):
    """The pool has no batch axis and replicates over the data axes: each
    model column's pool is the same bytes on every data row (each position
    of the pair on the pod mesh)."""
    _, ours, _ = run
    cols = (body.POD_MESH if name in body.POD else body.MESH)[-1]
    for m in range(cols):
        for r in range(cols + m, WORLD, cols):
            np.testing.assert_array_equal(ours[m][name + ":pool"],
                                          ours[r][name + ":pool"])
    # MLA pools replicate over the model axis too; a GQA pool's K/V split
    # over it while their fp8 scales (leaves 2 and 3) replicate
    same = (slice(2, 4) if body.SCENARIOS[name][0].startswith("qwen")
            else slice(None))
    for o in ours[1:]:
        np.testing.assert_array_equal(o[name + ":pool"][same],
                                      ours[0][name + ":pool"][same])


def _summary(ours, name, rank=0):
    return json.loads(str(ours[rank][name + ":summary"]))


@pytest.mark.parametrize("name,ref_key,parts", [
    ("gqa_chunked", "qwen_shared", ("streams", "prefix")),
    ("gqa_chunked_fp8", "qwen_shared_fp8", ("streams", "prefix")),
    ("gqa_chunked_preempt", "qwen_preempt", ("streams",)),
    ("gqa_tier", "qwen_tier", body.SUMMARY),
    ("pod_gqa_tier", "qwen_tier", body.SUMMARY),
    ("gqa_tier_crc", "qwen_tier_crc", body.SUMMARY)])
def test_chunked_and_tiered_runs_equal_the_reference(run, name, ref_key,
                                                     parts):
    """Chunked prefill (a shared 16-token prefix; a priority-5 arrival
    preempting a resident) and the host page tier (the oversubscribed
    bench, at (2, 4) and at (2, 2, 2); a CRC failure on one rank's host
    copy) on the mesh: streams, prefix, pool and tier figures and
    ``stats`` but ``dispatches`` exactly the JAX single-device engine's,
    on every rank."""
    ref, ours, _ = run
    want = ref[ref_key]
    for r in range(WORLD):
        got = _summary(ours, name, r)
        for part in parts:
            assert got[part] == want[part], (r, part, got[part], want[part])
    got = _summary(ours, name)
    if name == "gqa_chunked_preempt":
        assert got["stats"]["evictions"] >= 1
    elif "tier" in name:
        t = got["tier"]
        assert t["suspensions"] > 0 and t["fetched_pages"] > 0
        assert (t["crc_failures"] >= 1 and t["degraded"] >= 1) == (
            name == "gqa_tier_crc")
    else:
        assert got["prefix"]["hits"] >= 4


def test_mla_chunked_within_documented_tolerance(run):
    """DeepSeek-V3 paged bf16 chunked under the mesh (``ep_flat``, fp32
    wire) against the JAX single-device chunked engine: at least 0.9 of
    tokens (the ``mla_paged`` contract), the prefix figures exact."""
    ref, ours, _ = run
    got = _summary(ours, "mla_chunked")
    mf = _match_frac(ref["moe_shared"]["streams"], got["streams"])
    print("mla chunked matched", mf)
    assert mf >= 0.9, mf
    assert got["prefix"] == ref["moe_shared"]["prefix"]


@pytest.mark.parametrize("name", list(body.FAULTS))
def test_planted_faults_fail_the_contract(run, name):
    """A tier fetch installing the whole payload's first model column on
    every rank (not this rank's KV-head cut), and a prefill chunk writing
    the next column's K/V heads into this rank's pool: each parts from
    the reference's streams, so the contracts above would reject it."""
    ref, ours, _ = run
    got = _summary(ours, name)
    want = ref["qwen_tier" if "tier" in name else "qwen_shared"]["streams"]
    if "tier" in name:
        assert got["tier"]["fetched_pages"] > 0     # the fault was reached
    assert got["streams"] != want[:len(got["streams"])]


def test_slot_aux_travels_from_its_data_row(run):
    """On the (2, 2, 2) mesh, DeepSeek-V3's slot-resident MTP leaves (the
    aux a suspension carries) hold only the owning data row's slots: each
    slot's aux, gathered for the tier, reads the owner's rows on every
    rank, and an install writes the owning row's alone."""
    _, ours, _ = run
    assert all(bool(o["pod_card_path:aux"][0]) for o in ours)


def test_ep_engines_report_their_decode_alltoall_bytes(run):
    _, ours, _ = run
    for name in ("ep_flat", "ep_dedup", "fp8_wire", "card_path"):
        assert len({int(o[name + ":a2a"][0]) for o in ours}) == 1
        assert int(ours[0][name + ":a2a"][0]) > 0
    assert int(ours[0]["gqa_dense:a2a"][0]) == 0      # no experts


def test_ctx_none_and_unmeshed_ctx_are_single_device():
    cfg = tsmoke(tget("qwen3-14b"))
    for ctx in (None, ParallelCtx()):
        eng = ServeEngine(cfg, slots=2, max_len=16, ctx=ctx, device="cpu")
        assert not eng.meshed
        assert eng.decode_alltoall_bytes() == 0


@pytest.mark.parametrize("impl", ["ep_flat", "ep_dedup"])
def test_overlap_doubles_the_alltoalls_in_one_step(run, impl):
    """Per MoE layer and decode step the dual path issues exactly twice
    the single path's all-to-alls (both halves' dispatch and combine),
    moving between 1x and 2x its bytes (2x where the half-batches pad to
    the capacity floor), and exactly ``decode_alltoall_bytes()``."""
    _, ours, _ = run
    print(impl, "all-to-alls a MoE layer and step, and bytes: single",
          ours[0][impl + ":record"][:2], "dual",
          ours[0][impl + "_overlap:record"][:2])
    for o in ours:
        n1, b1, _ = o[impl + ":record"]
        n2, b2, _ = o[impl + "_overlap:record"]
        assert n1 > 0 and n2 == 2 * n1, (n1, n2)
        assert b1 <= b2 <= 2 * b1, (b1, b2)
        assert b1 == o[impl + ":a2a"][0], (b1, o[impl + ":a2a"])
        assert b2 == o[impl + "_overlap:a2a"][0], (b2,
                                                   o[impl + "_overlap:a2a"])


@pytest.mark.parametrize("impl", ["ep_flat", "ep_dedup"])
def test_overlap_issues_b_between_a_dispatch_and_its_wait(run, impl):
    """In every MoE layer half B's attention is issued after half A's
    dispatch all-to-all and before A waits for it: A's dispatch is in
    flight under B's compute (the record of every rank)."""
    _, ours, _ = run
    assert all(o[impl + "_overlap:record"][2] == 1.0 for o in ours)


def test_cross_mesh_disaggregation(run):
    """Prefill on (2, 4), decode on (1, 4) over ranks 0-3, the payload
    through host memory: dense streams exactly the JAX single-device
    engine's (DeepSeek-V3, and qwen3-14b whose K/V the model axis cuts),
    paged bf16 at least 0.9 of them, the paged handoff smaller than the
    dense one; ranks 4-7 only prefill."""
    ref, ours, _ = run
    dense, paged = _streams(ours, "disagg_dense"), _streams(ours,
                                                            "disagg_paged")
    assert dense == ref["moe"][0], (dense, ref["moe"][0])
    # GQA K/V cut over the model axis on both meshes: the whole payload
    # crosses, each decode rank takes its KV heads
    gqa = _streams(ours, "disagg_gqa")
    assert gqa == ref["qwen"][0], (gqa, ref["qwen"][0])
    mf = _match_frac(ref["moe"][0], paged)
    print("cross-mesh paged bf16 matched", mf)
    assert mf >= 0.9, mf
    decode_ranks = body.DECODE_MESH[0] * body.DECODE_MESH[1]
    for r, o in enumerate(ours):
        (nd, cross_d), (np_, cross_p) = (o["disagg_dense:handoff"],
                                         o["disagg_paged:handoff"])
        assert cross_d == cross_p == 1
        if r < decode_ranks:
            assert 0 < np_ < nd, (r, np_, nd)
            np.testing.assert_array_equal(o["disagg_dense"],
                                          ours[0]["disagg_dense"])
        else:
            assert nd == np_ == 0 and (o["disagg_dense"] < 0).all()


def test_decode_overlap_still_raises():
    """``decode_overlap=True`` serves; the reference's constructor checks
    still raise: an odd slot count, a paged cache, MTP drafting."""
    cfg = tsmoke(tget("qwen3-14b"))
    with pytest.raises(ValueError, match="even"):
        ServeEngine(cfg, slots=3, max_len=32, decode_overlap=True,
                    device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, slots=4, max_len=32, paged=True, page_size=8,
                    decode_overlap=True, device="cpu")
    with pytest.raises(ValueError, match="use_mtp"):
        ServeEngine(tsmoke(tget("deepseek-v3-671b")), slots=4, max_len=32,
                    use_mtp=True, decode_overlap=True, device="cpu")
    assert ServeEngine(cfg, slots=4, max_len=32, decode_overlap=True,
                       device="cpu").decode_overlap
