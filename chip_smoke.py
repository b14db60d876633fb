#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

from the root of a checkout. Phases, each fatal on failure:

  (a) environment: the card's name and power limit (nvidia-smi), the
      torch/CUDA versions; build every kernel under src/repro_torch/csrc
      with nvcc (one process per source, in parallel) and time the build;
      ptxas's registers, spills and warnings (any spill in fp8_gemm,
      mla_decode or logfmt_encode fails); the count of HGMMA (wgmma) and
      UTMALDG (TMA load) instructions in flash_prefill's and fp8_gemm's
      SASS, of UBLKCP (bulk copy) and UTMALDG in moe_gemm's, and of LDGSTS
      (cp.async) in the three split-KV decode kernels' (cuobjdump); a
      count of 0 fails;
  (b) kernels: each hand-written kernel against its plain PyTorch version
      on the card, at the shapes the main path gives it, with the stated
      tolerance; per kernel the kernel time, the plain version's time, the
      bound (least time for the bytes it must move or the operations it
      must do, at the H100's published peaks) and, where one PyTorch call
      computes the same function, that call's time (``library_ms``);
      fp8_gemm at every (K, N) the DeepSeek-V3 paths serve, at M = 4 (its
      decode; timed in a CUDA graph, warm and cold: rotating over copies
      of the weight that exceed twice the L2) and M = 1024 (the prefill
      bucket; in a graph too), and the earlier rows at M = 512, each with
      its launch plan,
      the bound at the fp16 rate beside the fp8 one, bf16 torch.matmul on
      the dequantized operands (a yardstick) and the wrapper's host time
      per eager call; flash_prefill at qwen3-14b's 2048 bucket (the table's
      row), at the 128 and 512 buckets, at the 2048 bucket of glm4-9b
      (32 heads over 2) and qwen1.5-4b (20 over 20), and at qwen3-14b's
      prefill chunk (256
      queries at positions 1280-1535 against 2048 keys; SDPA with a boolean
      mask), each with its kernel / SDPA ratio;
      moe_gemm with E4M3 and bf16 weights at C = 8 and 40, w1/w3 and w2
      (the table's row: E4M3, C = 8, w1/w3), and bf16 at qwen3-moe's
      (128 x 2048 <-> 768) and llama4's (128 x 5120 <-> 8192) experts at
      C = 8 and at the 2048 bucket's capacity (160 and 24), each against
      torch.bmm,
      the two timed in turns before any plain version runs; the three
      split-KV decode kernels first of all, every row of the three timed
      before any plain version runs, inside a CUDA graph (their wrappers'
      host time exceeds the kernels') warm and cold (rotating over copies
      of the pools or rings whose rows exceed twice the 50 MB L2), with its
      split plan, active CTAs and partial bytes: paged_gqa_decode at
      qwen3-14b's widths, four slots at contexts 600-1500 (fp8 pool: the
      table's row; bf16 pool) and one at 2048, and on fp8 pools at the
      other GQA paths' G = 1, 7, 8 and 16 (``GQA_ROWS``), paged_mla_decode at
      DeepSeek-V3's, four slots at 64-1024 (the table's row) and one at
      1024, mla_decode at DeepSeek-V3's over four rings of 1024 (bf16: the
      table's row; fp32), T = 1000 with an empty slot (exactly zero), a
      wrapped ring, the served contexts 600-900 and stale rows past qpos,
      each also timed eagerly, the full rings against SDPA; the LogFMT pair
      at the compressed ring's hop chunk, (1792, 18432) fp32 at 8 and 10
      bits, timed with them before any plain version runs, in a CUDA graph
      and eagerly, with the wrappers' host time per eager call, and
      logfmt_encode on the edge tiles of kernels/logfmt/edge.py at 2-16
      bits (codes equal to the plain version's on the structured ones);
  (c) the main paths, each served by ``ServeEngine(attn_impl="pallas")``
      with seeded random weights drawn on the card, six seeded prompts, 32
      new tokens each, greedy:
      - DeepSeek-V3 at published widths, depth cut 61 -> 4 (three dense
        layers, one MoE layer), ``fp8_impl="pallas"``, paged fp8 cache,
        prompts of 16-600 tokens (kernels fp8_gemm, moe_gemm,
        paged_mla_decode);
      - qwen3-14b whole (40 layers, published widths), paged fp8 cache,
        prompts of 16-1500 tokens, max_len 2048 (kernels flash_prefill,
        paged_gqa_decode);
      - DeepSeek-V3 as above on the dense ring cache with MTP drafting
        (``paged=False, use_mtp=True``; kernels fp8_gemm, moe_gemm,
        mla_decode, 4 launches a decode step, and never
        paged_mla_decode);
      - qwen3-moe-30b-a3b whole (48 layers, 30.53 B parameters, bf16),
        ``fp8_impl="pallas"``, paged fp8 cache, qwen3-14b's prompts and
        max_len: softmax routing, its bf16 routed experts through
        moe_gemm's bf16 format (144 launches a step), flash_prefill,
        paged_gqa_decode (48 a step), never fp8_gemm; the graphed step is
        printed against the expert wall's bytes at the card's memory rate
        (a floor: the capacity-buffer product reads every expert); then
        chunked (one TTFT run of each kind);
      - llama4-maverick at published widths cut 48 -> 4 layers (two
        dense/MoE pairs, 35.29 B parameters): top-1 routing plus the
        shared expert, moe_gemm's bf16 format 6 launches a step,
        paged_gqa_decode 4, never fp8_gemm;
      - glm4-9b (G = 16), qwen1.5-4b (G = 1) and yi-34b (G = 7), published
        widths cut to 8 layers each: flash_prefill, paged_gqa_decode 8 a
        step;
      - the recurrent families on the dense engine, whole at published
        widths, bf16 (``phase_recurrent_path``): mamba2-2.7b (64 SSD
        layers, qwen3-14b's prompts and max_len) and recurrentgemma-9b (12
        x (recurrent, recurrent, local attention) + 2 recurrent, window
        2048, prompts of 16-3000 tokens, max_len 4096: the 3000-token
        prompt wraps the windowed ring in prefill, the 2040-token one
        during decode). No op of the port's registry may launch (the
        reference dispatches none for them); no cache leaf's data_ptr may
        move; the recurrent states must be fp32; the decode chunk must be
        captured once and equal the eager chunk. Printed: tok/s, TTFT,
        graphed and eager ms a step in turns against the step's byte
        floor, a profile of one graphed chunk, the longest prompt's
        prefill ms (2 runs), peak memory, and the decode state's bytes a
        slot beside DeepSeek-V3's MLA latent at the same context;
      - the families with a memory (``phase_memory_path``), each request
        carrying seeded extras: seamless-m4t-large-v2 whole (24 encoder +
        24 decoder layers, 2.035 B parameters, bf16) on paged fp8 pages,
        qwen3-14b's prompts and max_len (a 512-row memory leaf), frames of
        64-512 rows (the shorter ones zero-padded into the leaf, as the
        reference's); flash_prefill 24 a prefill and paged_gqa_decode 24 a
        step (the decoder's self-attention: the encoder and the
        cross-attention run the plain path, as the reference's); and
        llama-3.2-vision-90b at published widths cut 100 -> 10 layers (two
        whole patterns: 2 gated cross-attention + 8 self-attention layers,
        10.66 B parameters) on the dense engine, its gates drawn non-zero
        before serving, (1, 1601, 8192) patch embeddings a request;
        flash_prefill 8 a prefill, no kernel at decode. Gated: the launch
        counts a step and a prefill, every other op 0, one capture equal
        to the eager chunk, no page leaked, no cache leaf moved (the
        memory leaf among them). Printed: TTFT, graphed and eager ms a
        step against a byte floor, prefill ms, a profile, peak memory.
      The engine decodes through its chunk's CUDA graph (``serve/
      graph.py``: captured on the second chunk, replayed every tick after;
      launches counted as the capture's tally times its replays). Every
      request must finish with the right count of in-vocabulary tokens, no
      page may leak, each kernel of the path must have launched (counters
      zeroed just before the path, read just after), the MTP path must
      draft, the chunk must have been captured once (``trace_counts``), and
      the same six requests on the same weights through an engine whose
      chunk runs eagerly must give the same streams (and draft and accept
      counts). On the DeepSeek-V3 paths every routed expert matrix must be
      stored as E4M3 codes (the count stored in the weight dtype, and the
      expert wall's bytes, are printed), on the bf16 MoE paths none, and a
      decode step must launch moe_gemm three times per MoE layer. Per path: tokens/s end to end,
      TTFT, the graph's capture and instantiation seconds and its pool's
      bytes, launches per decode step from one replay of the engine's
      8-step graph (the paged paths must launch their attention op once
      per layer and step: 4 and 40, and so must the dense path: 4; a
      DeepSeek-V3 step must launch fp8_gemm 29 times paged, 38 times with
      the MTP draft), steady decode ms/step at four slots, graphed and
      eager in turns (with and without the draft on the MTP path, and
      there dense rings against a paged pool on the same weights, in
      turns), the longest prompt's prefill ms (3 runs) and a torch.profiler
      split of that prefill, peak memory, and torch.profiler splits of two
      eager decode steps and of one graphed chunk (busy share, kernels a
      step, device ms a step by kernel group; the groups of fp8_gemm and
      of each split-KV kernel listing their kernels). Each paged path then
      serves again on the same weights through a chunked-prefill engine
      (``prefill_chunk=256``, ``phase_chunked``), whose prefill chunk is a
      CUDA graph too (eager on the engine's first chunk, captured on its
      second, one replay a chunk after): its six prompts, a request
      cancelled mid-prefill, three requests sharing a 512-token prefix and
      a priority-5 arrival that must evict. Gates: every request
      finishes, the cancel holds, no page leaks, prefix hits, an eviction,
      one capture of each graph (``trace_counts == {"decode": 1, "chunk":
      1}``), exact launch counts (per prefill chunk and per decode step),
      the shared streams equal to each request alone on a cold engine, and
      a replayed chunk equal to the eager chunk bit for bit (logits,
      written pages, ``mtp_h``). Printed: the victim against an
      uninterrupted run, chunked against whole-prompt streams, the TTFT of
      the longest prompt chunked-graphed, chunked-eager and whole-prompt
      in turns with three residents decoding, the residents' ms per tick
      with and without that prompt streaming, ms per chunk graphed and
      eager with the synchronising calls of each tick, the chunk graph's
      capture seconds and pool bytes, a profile of one replayed chunk and
      peak memory;
  (d) a reference check on a small input, per engine: the same engine at
      smoke width (bf16; each GQA path keeps its published query heads per
      KV head at head_dim 32, ``SMOKE_OVERRIDES``) on
      the card, through the kernels and the graphs (each captured once),
      against the plain versions on the CPU (eager, nothing captured),
      same weights — each path of (c), qwen3-14b on the dense engine, the
      chunked paths chunked (``prefill_chunk=8``; their first-token
      logits through ``Model.prefill_chunk``), and recurrentgemma at 5
      layers (its rg_tail); the recurrent families' prompts (28-50
      tokens) pass the smoke window of 32;
  (e) the LogFMT-compressed ring all-reduce (``compressed_psum``): 4 rank
      processes on the one card in a gloo group (FileStore in a temporary
      directory; the wire payload staged through pinned host memory), each
      summing its (7168, 18432) fp32 tensor — the gradient of one
      DeepSeek-V3 dense layer's w1 at published width — at 8 and 10 bits
      (kernels logfmt_encode, logfmt_decode: 6 launches of each per call
      and rank, counters zeroed just before each call). Gates: the launch
      counts, finite outputs of x's shape and dtype, every member within
      0.05 of max|exact| at 10 bits (exact: the fp32 sum of the four
      inputs, regenerated from their seeds), and the card's ring against
      the same ring on the CPU ranks (plain codec) on (1024, 2048) inputs
      from numpy seeds. Printed: the error at 8 bits, bytes on the wire,
      wall ms per call (4 gloo ranks on one card: not a wire figure) and
      the kernels' share of it (at phase (b)'s graph times), peak memory
      per rank; and, in two more processes, whether gloo's
      point-to-point ops take CUDA tensors.

  (f) run right after each paged path's phase (c), on its weights (counters
      zeroed just before each run and read just after; every gate fatal):
      - the host KV tier on qwen3-14b whole (``phase_tier``): a chunked
        engine of two slots (chunks of 256, max_len 2048, fp8 pages) whose
        pool holds two full requests and whose host tier holds three times
        that, decode quantum 2, and an untiered engine of as large a pool
        (nobody preempted) serve eight seeded prompts of 400-1500 tokens, 32
        new tokens each. Gates: streams bitwise equal, suspensions > 0 and
        as many resumes, spilled pages == fetched pages > 0, no CRC failure
        or degradation, no page leaked and no tier entry left,
        ``trace_counts == {"decode": 1, "chunk": 1}``, every cache leaf's
        ``data_ptr`` unchanged, every staged copy into pinned memory,
        flash_prefill and paged_gqa_decode launched. Printed: spill and
        fetch bytes, ms and GB/s of each staged copy, page-CRC ms per spill
        and per fetch, ms per tick with and without a staged copy, the host
        tier's peak bytes;
      - the gateway on DeepSeek-V3 paged (``phase_gateway``): two replicas
        of a chunked engine with a host tier on phase (c)'s weights, six
        requests of 300-600 tokens; a fault-free pass, then ``crash:1`` at
        the first tick where replica 1 has a request mid-decode and
        ``pcie_drop:0`` from the tick after replica 0's first spill. Gates:
        every request done with its tokens, no delivered token regenerated,
        replica 1 DEAD and its residents retried on replica 0, the expert
        codes one tensor across phase (c)'s engine and both replicas, the
        gateway's growth in allocated memory under its pools plus their
        graph pools (plus 256 MB), the three kernels launched, a replica
        spilled. Printed: where each retried stream parts from the
        fault-free one;
      - disaggregation on DeepSeek-V3 paged (``phase_disagg``):
        ``Disaggregator(paged=True)`` on phase (c)'s six prompts. Gates:
        streams bitwise equal to the engine's own admission, handoff_bytes
        the sum of ``cache_nbytes`` over the payloads, the kernels launched.
        Printed: bytes per request.

  (g) training on the card (counters zeroed just before each step and read
      just after; every gate fatal):
      - (g.1) the three fp8_gemm products of every FP8 weight of the
        training config at T = 1024 tokens: the forward (T, K=d_in) x
        (d_in, N=d_out), the backward's dx (T, K=d_out) x (d_out, N=d_in)
        and dw (d_in, K=T) x (T, d_out), their operands made as the FP8
        linear makes them (``fp8_gemm.operands``: x2ᵀ a transposed view,
        w_kr's K = 64 padded), each within 2e-5 of the plain version's max,
        timed in a CUDA graph, with its launch plan, the bound at the fp8
        and fp16 rates, torch._scaled_mm and bf16 torch.matmul on the
        dequantized operands as yardsticks, and the eager call with its
        plain quantization; then a step's sums by pass;
      - (g.2) DeepSeek-V3's dense prefix at published widths (its three
        dense layers and the MTP module: ``family="dense", moe=None,
        num_layers=3``, 4.29 B parameters; the MoE layers' 11.3 B would
        not fit with their optimizer state), bf16, ``fp8_impl="pallas"``,
        trained 6 steps by ``Trainer`` (parameters drawn on the card from
        a seed, ``SyntheticCorpus`` 2 x 512 tokens, peak lr 3e-4, warmup
        2, no checkpoints). Gates: fp32 master and bf16 m, v and
        parameters; one forward pass launches fp8_gemm once per FP8
        linear of the specs (41) and each step exactly three times that
        and nothing else; every master leaf unchanged after step 0 (lr 0)
        and changed after step 1; finite losses; peak memory under the
        card's. Printed: losses, ms a step, tokens/s, peak memory against
        the state's 12 B a parameter, and a torch.profiler split of a
        seventh step's forward, backward and optimizer; then the same six
        steps with the FP8 linears on the plain path (``fp8_impl="ref"``)
        and at a tenth of the peak lr (``TRAIN_CURVES``), the three
        curves printed side by side;
      - (g.3) on small inputs, the same weights and batches on the card
        (kernels, CUDA plain ops) and on the CPU (plain versions), three
        steps each: (i) the dense prefix at smoke width, bf16, FP8 through
        fp8_gemm (15 launches a step); (ii) smoke DeepSeek-V3 with its MoE
        layers, fp32, FP8 inline; each step's loss within 2e-2 relative,
        each master leaf within 2.1 x the steps' summed lr of the CPU's
        element by element (Adam's step bound) and its update within
        cosine 0.9 of the CPU's; (iii)
        a Trainer with checkpoints and FailureInjector({9: "node", 18:
        "sdc"}) on the card must end at step 22 with one restart and the
        alarm at 18; and moe_gemm and fp8_gemm called with a grad-requiring
        input must raise.

  (h) mesh-sharded serving (``phase_mesh``): ``ServeEngine(ctx=
      ParallelCtx(mesh=(1, 4)))`` on 4 spawned gloo ranks sharing the card
      (collectives staged through pinned host memory, chunks eager):
      DeepSeek-V3 paged fp8 as phase (c)'s path with ``moe_impl=
      "ep_flat"`` at the fp32 and the FP8 wire (its 256 experts 64 a
      rank, 32 of 128 heads a rank), then qwen3-14b whole (10 of 40 heads
      over 2 of 8 KV heads a rank, 8 new tokens a request: ``MESH_NEW``),
      on phase (c)'s weights and prompts.
      Gates and figures: ``phase_mesh``. Then the dual-microbatch decode
      (``decode_overlap=True``) and the cross-mesh disaggregator:
      - first, on one device in this process (``phase_overlap_single``),
        DeepSeek-V3 (4 layers, published widths, dense ring, no draft)
        and qwen3-14b whole on the dense ring, graphed, single and dual
        engines on one set of weights; gates: one capture each, every
        request done, each kernel's launches a dual step twice the single
        step's (``OVERLAP_STEP``: fp8_gemm 58, moe_gemm 6, mla_decode 8),
        the first dual step's logits within ``OVERLAP_LIMITS`` of the
        single step's on the same cache; printed: graphed ms a step in
        turns, where the streams part, a profile of each chunk;
      - in the 4 ranks, DeepSeek-V3 on the dense ring at (1, 4),
        ``ep_flat``, FP8 wire, single and dual on the paged run's placed
        weights (``mesh_overlap``); gates: all-to-alls a MoE layer and
        step exactly 2x, their bytes in [1x, 2x] and equal to each
        engine's ``decode_alltoall_bytes()``, the first dual step's
        logits within ``MESH_LIMITS`` of the single-scan mesh's; printed:
        eager ms a step in turns, host seconds inside staged collectives
        and seconds a half's collective was in flight under the other
        half's work (``collectives.record()``);
      - in the 4 ranks, ``Disaggregator(ctx=, prefill_ctx=)`` on
        DeepSeek-V3, prefill at (1, 4), decode at (1, 2) over ranks 0-1,
        paged fp8 and dense (``mesh_disagg``); gates: every rank
        cross-mesh, every request done on the decode ranks,
        ``handoff_bytes`` the sum of ``cache_nbytes`` over the payloads,
        the kernels launched, peak memory a rank under the card's;
        printed: streams against phase (c)'s.

  (i) the meshed train step (``phase_train_mesh``): ``Trainer(ctx=
      ParallelCtx(mesh=...))`` on 4 spawned gloo ranks sharing the card.
      - (i.1) DeepSeek-V3's dense prefix at published widths cut to one
        dense layer plus the MTP module (``MESH_TRAIN``), bf16,
        ``fp8_impl="pallas"``, global batch 4 x 256 tokens, mesh (2, 2):
        FSDP over data (each layer's data cut gathered as the model
        reaches it, its gradient reduce-scattered), TP over model, the
        dual microbatch, 3 steps. First, in this process, the same config
        on one device from the same seed-drawn weights, and the witness
        (one device with its sums reordered as the mesh's:
        ``mesh_witness``, ``witness_step``), keeping only losses, grad
        norms and the step-1 update at a seeded sample of each leaf's
        elements (``master_samples``). Gates: every step finite;
        fp8_gemm exactly 2 x 3 x the FP8 linears of a forward a rank and
        step, nothing else; fp32 master and bf16 m, v on every rank; the
        mesh and the witness within ``MESH_TRAIN_LIMITS`` of one device
        (``train_gate``: loss, grad norm, least update cosine) and each
        planted fault (``MESH_TRAIN_FAULTS``: one data rank's gradients
        left out of the data-axis reduction; the column-parallel input's
        backward all-reduce skipped) outside them; peak memory a rank and
        the ranks' sum under the card's. Printed: ms a step a rank, host
        s inside staged collectives, bytes gathered and reduce-scattered
        over data a step, launches;
      - (i.2) smoke DeepSeek-V3 with its MoE layers, fp32, capacity 8:
        ``ep_flat`` at (2, 2) at the fp32 and the FP8 wire, ``ep_dedup``
        at (1, 4), 3 steps each against one device on the card (losses
        within 5e-3, the FP8 wire within 5% of the fp32 wire); then a
        Trainer at (2, 2) with checkpoints and ``FailureInjector({3:
        "node"})`` must end at (1, 2) after one restart, ranks 2-3 gone;
      - (i.3) ``pipeline_forward`` on ("pipe",) of the 4 ranks: forward
        within 1e-5 and gradients within 1e-4 of the sequential stages.

The line before the last two is one JSON object with the kernel table
(fp8_gemm's training backward rows, dx and dw at the FFN's w_gate/w_up,
added after the eight kernels); the next is the nvidia-smi name and power
limit; the last is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits non-zero before printing any result.
"""
import contextlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# the port from this checkout; outside one this import fails, and the
# script exits non-zero before printing any result
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch import costs  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit),
# one copy in the port's cost model; "sfu": transcendentals (log, exp) at
# 16 results per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) on 132 SMs at the
# 1.98 GHz boost clock
HBM_BYTES_PER_S = costs.HBM_BW
PEAK_FLOPS = {"fp8": costs.PEAK_FLOPS_FP8, "bf16": costs.PEAK_FLOPS,
              "fp32": costs.PEAK_FLOPS_FP32, "sfu": 16 * 132 * 1.98e9}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, flops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean ms per call, from CUDA events around ``iters`` back-to-back
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def max_row_err(torch, got, ref):
    """Largest error over output rows (the last axis), each relative to
    its own row: max_r ||got_r - ref_r|| / ||ref_r||. A row that should be
    zero must come out zero."""
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    d = (got - ref).norm(dim=-1)
    n = ref.norm(dim=-1)
    return float(torch.where(n > 0, d / n.clamp_min(1e-30),
                             d * 1e30).max())


# --- (a) ---------------------------------------------------------------------


def phase_env(torch, build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"[a] card: {card}")
    log(f"[a] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    secs = build.build(build.sources())
    log(f"[a] nvcc build of {build.sources()}: {time.perf_counter() - t0:.2f} s"
        f" wall ({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")
    for name in build.sources():
        for line in build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                log(f"[a]   {name}: {line.strip()}")
    for name in NO_SPILLS:
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                             build.build_log(name))]
        if any(spills):
            raise AssertionError(f"{name}: ptxas spills registers "
                                 f"({sum(spills)} bytes over its kernels)")
    sass_counts(build)
    return card


# the instructions each kernel's design rests on: flash_prefill and
# fp8_gemm's prefill kernel run on wgmma (HGMMA) fed by TMA (UTMALDG); moe_gemm streams its weights by bulk
# copies (UBLKCP: code blocks) and TMA (UTMALDG: x rows, bf16 weights); the
# split-KV decode kernels (the paged pair, mla_decode over the dense ring)
# copy their rows with cp.async (LDGSTS)
SASS_OPS = {"flash_prefill": ("HGMMA", "UTMALDG"),
            "fp8_gemm": ("HGMMA", "UTMALDG"),
            "moe_gemm": ("UBLKCP", "UTMALDG"),
            "paged_gqa_decode": ("LDGSTS",),
            "paged_mla_decode": ("LDGSTS",),
            "mla_decode": ("LDGSTS",)}


# kernels whose build must spill no register
NO_SPILLS = ("fp8_gemm", "mla_decode", "logfmt_encode")


def sass_counts(build):
    """Count the instructions of ``SASS_OPS`` in each kernel's library
    with cuobjdump (where the toolkit has it); a count of 0 fails."""
    import shutil
    tool = (shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump")
    if not pathlib.Path(tool).exists():
        log("[a] SASS: cuobjdump not found (not measured)")
        return
    for name, ops in SASS_OPS.items():
        sass = subprocess.run([tool, "-sass", str(build.library(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        # "/*0af0*/  [@P0 ]OPCODE.MODIFIERS operands ;"
        codes = [m.group(1) for m in re.finditer(
            r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", sass,
            re.M)]
        counts = {op: codes.count(op) for op in ops}
        log(f"[a] SASS of {name}: " + ", ".join(
            f"{op} x{n}" for op, n in counts.items()))
        missing = [op for op, n in counts.items() if not n]
        if missing:
            raise AssertionError(f"{name}: the library holds no {missing}")


# --- (b) ---------------------------------------------------------------------


def check(name, err_rel, tol, of="max|plain|"):
    if not (err_rel <= tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max error {err_rel:.3g} of {of} "
                             f"> tolerance {tol:.3g}")


def bench_fp8_gemm(torch, dev, gen):
    """fp8_gemm at the earlier rows (M = 4 and 512, w_o and the FFN's
    w_gate/w_up: the table's row is M = 4, w_gate/w_up), then every other
    served shape at M = 4 and every served shape at M = 1024. Every row is
    timed in a CUDA graph (the wrapper's host time exceeds the small
    shapes' kernels; bf16 torch.matmul likewise); decode rows (M <= 64)
    warm and cold, and their ``ms`` is the cold time, each launch reading
    its weight from device memory, as a decode step does. The weight is
    stored K-contiguous, as the load makes it."""
    from repro_torch.core import fp8
    from repro_torch.kernels import registry
    from repro_torch.kernels.fp8_gemm import ops
    tol = 2e-5    # fp32 sums of exact products in another order
    sms = registry.sm_count(dev)
    cases = [(4, "w_o", 16384, 7168), (4, "w_gate/w_up", 7168, 18432),
             (512, "w_o", 16384, 7168), (512, "w_gate/w_up", 7168, 18432)]
    cases += [(4, w, K, N) for w, (K, N) in ops.SERVED_KN.items()
              if w not in ("w_o", "w_gate/w_up")]
    cases += [(1024, w, K, N) for w, (K, N) in ops.SERVED_KN.items()]
    rows = []
    for i, (M, what, K, N) in enumerate(cases):
        x = torch.randn(M, K, generator=gen, device=dev)
        w = torch.randn(K, N, generator=gen, device=dev) * 0.02
        xq, xs = fp8.quantize_tilewise(x)
        wq, ws = fp8.quantize_blockwise(w)
        wq = fp8.k_major(wq)
        del x, w
        y = ops.fp8_gemm(xq, xs, wq, ws)
        ref = ops.fp8_gemm.run_plain(xq, xs, wq, ws)
        err, rel = max_err(torch, y, ref)
        check(f"fp8_gemm {M}x{K}x{N}", rel, tol)
        plan = ops.launch_plan(M, N, K, sms)
        xb = fp8.dequant_tilewise(xq, xs).bfloat16()
        wb = fp8.dequant_blockwise(wq, ws).bfloat16()
        row = dict(shape=f"M={M} K={K} N={N} ({what})", max_abs_err=err,
                   rel_err=rel, tol=tol, plan=plan)
        if M <= ops.DECODE_MAX_M:
            wbytes = K * N + ws.numel() * 4
            n = max(2, math.ceil(2 * L2_BYTES / wbytes))
            copies = [(wq.clone(), ws.clone()) for _ in range(n)]
            row["warm_ms"] = graph_ms(torch, [
                lambda: ops.fp8_gemm(xq, xs, wq, ws)] * 20)
            row["cold_ms"] = graph_ms(torch, [
                (lambda c=c: ops.fp8_gemm(xq, xs, *c)) for c in copies],
                reps=3)
            row["ms"], row["copies"] = row["cold_ms"], n
            row["bf16_mm_ms"] = graph_ms(torch, [
                lambda: torch.matmul(xb, wb)] * 20)
            del copies
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                ops.fp8_gemm(xq, xs, wq, ws)
            row["host_us"] = 1e6 * (time.perf_counter() - t0) / 200
            torch.cuda.synchronize()
        else:
            row["ms"] = graph_ms(torch, [
                lambda: ops.fp8_gemm(xq, xs, wq, ws)] * 10)
            row["bf16_mm_ms"] = graph_ms(torch, [
                lambda: torch.matmul(xb, wb)] * 10)
        row["plain_ms"] = cuda_ms(torch, lambda: ops.fp8_gemm.run_plain(
            xq, xs, wq, ws), 3)
        nbytes = M * K + M * (K // 128) * 4 + K * N + ws.numel() * 4 \
            + M * N * 4
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2 * M * N * K,
                                                    "fp8")
        row["bound16_ms"], _ = bound_ms(nbytes, 2 * M * N * K, "bf16")
        row["library_ms"] = (scaled_mm_ms(torch, xq, xs, wq, ws, ref)
                             if i < 4 else None)
        split = (f"decode: {plan.grid} CTAs x {plan.per} units (128 x 128 B "
                 f"of the weight each), up to {plan.maxc} partials a tile"
                 if plan.mode == "decode" else
                 f"prefill: {plan.grid} persistent CTAs over "
                 f"{-(-M // 128) * -(-N // 128)} tiles of 128 x 128")
        timing = (f"graph warm {row['warm_ms']:.4f} ms, cold "
                  f"{row['cold_ms']:.4f} ms (rotating over {row['copies']} "
                  f"copies of the weight), host {row['host_us']:.1f} us per "
                  "eager call" if "cold_ms" in row else
                  f"graph {row['ms']:.4f} ms")
        log(f"[b]   fp8_gemm {row['shape']}: {split}; {timing}; bound "
            f"{row['bound_ms']:.4f} ms at the fp8 rate ({row['bound_by']}), "
            f"{row['bound16_ms']:.4f} at the fp16 rate; bf16 torch.matmul "
            f"{row['bf16_mm_ms']:.4f} ms (kernel / matmul = "
            f"{row['ms'] / row['bf16_mm_ms']:.3f})")
        rows.append(row)
        del xq, xs, wq, ws, y, ref, xb, wb
        torch.cuda.empty_cache()
    return rows


def scaled_mm_ms(torch, xq, xs, wq, ws, ref):
    """torch._scaled_mm with 1x128 / 128x128 block scales, where the
    installed torch offers it and it computes the same function; else
    None (reported as null). A yardstick only: the port never calls it."""
    fn = getattr(torch, "_scaled_mm", None)
    if fn is None:
        log("[b]   library: torch._scaled_mm absent")
        return None
    b = wq                 # the stored K-contiguous layout: column-major
    attempts = (("scales as given", xs, ws),
                ("outer-dim-major scales", xs.t().contiguous().t(),
                 ws.t().contiguous().t()))
    for how, sa, sb in attempts:
        try:
            out = fn(xq, b, scale_a=sa, scale_b=sb, out_dtype=torch.float32)
        except (RuntimeError, TypeError, ValueError) as e:
            log(f"[b]   library: _scaled_mm ({how}) refused: "
                f"{str(e).splitlines()[0][:160]}")
            continue
        _, rel = max_err(torch, out, ref)
        if rel > 1e-3:
            log(f"[b]   library: _scaled_mm ({how}) computes another "
                f"function (rel err {rel:.3g}); not a yardstick")
            continue
        return cuda_ms(torch, lambda: fn(xq, b, scale_a=sa, scale_b=sb,
                                         out_dtype=torch.float32), 20)
    return None


# the routed-expert products of the served MoE paths: (E, D, F, which, the
# capacities, the weight formats). DeepSeek-V3 (FP8 path: E4M3 codes, and
# bf16) at decode (C = 8) and its 1024-token bucket (C = 40); qwen3-moe and
# llama4, whose experts serve as bf16, at decode and the 2048-token
# bucket's capacity (top-8: 160 rows, top-1: 24)
MOE_GEMM_ROWS = (
    (256, 7168, 2048, "w1/w3", (8, 40), ("e4m3", "bf16")),
    (256, 2048, 7168, "w2", (8, 40), ("e4m3", "bf16")),
    (128, 2048, 768, "qwen3-moe w1/w3", (8, 160), ("bf16",)),
    (128, 768, 2048, "qwen3-moe w2", (8, 160), ("bf16",)),
    (128, 5120, 8192, "llama4 w1/w3", (8, 24), ("bf16",)),
    (128, 8192, 5120, "llama4 w2", (8, 24), ("bf16",)))


def bench_moe_gemm(torch, dev, gen):
    """The rows of ``MOE_GEMM_ROWS``: DeepSeek-V3's routed experts, w1/w3
    (7168 -> 2048) and w2 (2048 -> 7168) over 256 experts, with the weights
    as E4M3 codes and block scales (the FP8 path's storage) and as bf16;
    qwen3-moe's (2048 <-> 768) and llama4's (5120 <-> 8192) over 128
    experts as bf16. ``library_ms`` is torch.bmm on the bf16 weights, which
    for the codes are their dequantized values (the same function)."""
    from repro_torch.core import fp8
    from repro_torch.kernels.moe_gemm import ops
    tol = 2 ** -7   # bf16 output: one rounding step of the largest value
    rows = []
    for E, D, F, what, caps, formats in MOE_GEMM_ROWS:
        w = (torch.randn(E, D, F, generator=gen, device=dev) * 0.02).bfloat16()
        codes = fp8.Fp8Experts.quantize(w) if "e4m3" in formats else None
        xs = {C: torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
              for C in caps}
        fmts = (("bf16", w, w),)
        if codes is not None:
            # the bf16 weights the codes hold
            fmts = (("e4m3", codes, codes.dequant()),) + fmts
        # The kernel and torch.bmm first, in turns (kernel, bmm, bmm,
        # kernel): whatever runs right after an fp32 plain version runs up
        # to a fifth slower (kernels/moe_gemm/probe.py), so no plain version
        # runs before these and both see the same state.
        times = {}
        for C, x in xs.items():
            for fmt, wk, wlib in fmts:
                kern = lambda: ops.grouped_matmul(x, wk)
                bmm = lambda: torch.bmm(x, wlib)
                t = [cuda_ms(torch, f, 10) for f in (kern, bmm, bmm, kern)]
                times[C, fmt] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        for C, x in xs.items():
            for fmt, wk, wlib in fmts:
                y = ops.grouped_matmul(x, wk)
                ref = ops.grouped_matmul.run_plain(x, wk)
                err, rel = max_err(torch, y, ref)
                name = f"moe_gemm {what} C={C} {fmt}"
                check(name, rel, tol)
                del y, ref
                ms, lib = times[C, fmt]
                plain = cuda_ms(torch, lambda: ops.grouped_matmul.run_plain(
                    x, wk), 2, warmup=1)
                wbytes = (codes.nbytes if fmt == "e4m3" else 2 * E * D * F)
                nbytes = wbytes + 2 * (E * C * D + E * C * F)
                b, by = bound_ms(nbytes, 2 * E * C * D * F, "bf16")
                log(f"[b]   {name}: kernel / torch.bmm = {ms / lib:.3f}, "
                    f"{nbytes / ms / 1e9:.3f} TB/s of the bound's bytes")
                rows.append(dict(
                    shape=f"E={E} C={C} D={D} F={F} ({what}, {fmt} "
                          "weights)",
                    max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
                    plain_ms=plain, bound_ms=b, bound_by=by,
                    library_ms=lib))
                torch.cuda.empty_cache()
        del w, codes, xs, fmts
        torch.cuda.empty_cache()
    return rows


L2_BYTES = 50e6   # the H100's L2


def graph_ms(torch, calls, reps=10):
    """Device ms per call: ``calls`` run once eagerly (build, warm-up), then
    captured in order into one CUDA graph, replayed ``reps`` times under
    CUDA events. The wrappers' host time, which exceeds the paged kernels'
    own, drops out; the capture also shows that the launch holds no host
    read."""
    from repro_torch.kernels import registry
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # timing launches: tallied, and never added to the launch counters
    with registry.tally(), torch.cuda.graph(graph):
        for fn in calls:
            fn()
    ms = cuda_ms(torch, graph.replay, reps, warmup=1) / len(calls)
    del graph
    return ms


def time_split_rows(torch, op, cases):
    """Kernel times of a split-KV decode op's cases (args, scale, pools: the
    indices of the operands that hold its rows, row_bytes: the row bytes
    one call reads), taken before any plain version runs: warm (20 calls on
    the same inputs) and cold (one call on each of enough copies of the
    pools that the rows they read together exceed twice the L2, so every
    call finds its rows in device memory), both in a CUDA graph; and,
    where a case asks for it (``eager``), eagerly."""
    for c in cases:
        args, scale = c["args"], c["scale"]
        c["ms"] = graph_ms(torch, [lambda: op(*args, scale=scale)] * 20)
        n = max(2, math.ceil(2 * L2_BYTES / c["row_bytes"]))
        copies = [tuple(x.clone() if i in c["pools"] and x is not None
                        else x for i, x in enumerate(args))
                  for _ in range(n)]
        c["cold_ms"] = graph_ms(torch, [
            (lambda a=a: op(*a, scale=scale)) for a in copies], reps=3)
        c["copies"] = n
        del copies
        torch.cuda.empty_cache()
        if c.get("eager"):
            c["eager_ms"] = cuda_ms(torch, lambda: op(*args, scale=scale), 50)


def check_split_rows(torch, op, cases, tol):
    """Each case of ``time_split_rows`` held against its plain version,
    whose time is taken here, with the library yardstick where the case
    has one (``library``: ref -> ms or None) and the slots that must come
    out exactly zero (``zero_slots``)."""
    rows = []
    for c in cases:
        args, scale = c["args"], c["scale"]
        y = op(*args, scale=scale)
        ref = op.run_plain(*args, scale=scale)
        err, rel = max_err(torch, y, ref)
        check(f"{op.name} {c['shape']}", rel, tol)
        for b in c.get("zero_slots", ()):
            if not bool((y[b] == 0).all()):
                raise AssertionError(f"{op.name} {c['shape']}: slot {b} has "
                                     "no valid row and is not exactly zero")
        plain = cuda_ms(torch, lambda: op.run_plain(*args, scale=scale), 5)
        lib = c["library"](ref) if c.get("library") else None
        b, by = bound_ms(c["bytes"], c["flops"], "fp32")
        rps, S = c["plan"]
        eager = (f", eager {c['eager_ms']:.4f} ms" if "eager_ms" in c
                 else "")
        log(f"[b]   {op.name} {c['shape']}: split plan {rps} rows x {S} "
            f"splits, {c['active']} active CTAs, partials {c['partial']} "
            f"bytes written; kernel warm {c['ms']:.4f} ms, cold "
            f"{c['cold_ms']:.4f} ms (rotating over {c['copies']} copies of "
            f"the {c.get('what', 'pools')}) in a CUDA graph{eager}, bound "
            f"{b:.4f} ms")
        row = dict(shape=c["shape"], max_abs_err=err, rel_err=rel, tol=tol,
                   ms=c["ms"], cold_ms=c["cold_ms"], plain_ms=plain,
                   bound_ms=b, bound_by=by, library_ms=lib)
        if "eager_ms" in c:
            row["eager_ms"] = c["eager_ms"]
        rows.append(row)
        del y, ref
    return rows


def bench_paged_mla(torch, dev, gen):
    """DeepSeek-V3's paged decode attention: 128 heads, R = 512, Rr = 64,
    page 8, an fp8 pool; four slots at contexts 64-1024 (the table's row)
    and one slot at 1024. Returns (op, cases, tolerance)."""
    from repro_torch.core import paged
    from repro_torch.kernels import registry
    from repro_torch.kernels.paged_attention import ops
    tol = 2e-5    # fp32 online vs full softmax, same exact dequantization
    H, R, Rr, page, pp = 128, 512, 64, 8, 128
    scale = 1.0 / math.sqrt(192)
    cases = []
    for ctx in ([64, 300, 700, 1024], [1024]):
        B = len(ctx)
        P = B * pp
        qa = torch.randn(B, H, R, generator=gen, device=dev)
        qr = torch.randn(B, H, Rr, generator=gen, device=dev)
        ckv, cs = paged.quantize_vecs(torch.randn(
            P + 1, page, R, generator=gen, device=dev))
        kr, ks = paged.quantize_vecs(torch.randn(
            P + 1, page, Rr, generator=gen, device=dev))
        ckv, kr = ckv.view(torch.uint8), kr.view(torch.uint8)
        table = torch.randperm(P, generator=gen, device=dev).reshape(B, pp)
        qpos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32,
                            device=dev)
        tokens = sum(ctx)
        rps, S = ops.mla_split_plan(B, H, page, pp, registry.sm_count(dev))
        groups = -(-H // ops.MLA_HEADS_PER_CTA)
        active = groups * sum(-(-c // rps) for c in ctx)
        cases.append(dict(
            args=(qa, qr, ckv, kr, cs, ks, table.int(), qpos), scale=scale,
            pools=(2, 3, 4, 5), plan=(rps, S), active=active,
            partial=active * ops.MLA_HEADS_PER_CTA * (R + 2) * 4,
            shape=f"B={B} H={H} R={R} Rr={Rr} page={page} contexts={ctx} "
                  "(fp8 pool)",
            row_bytes=tokens * (R + Rr + 8),
            bytes=(tokens * (R + Rr + 8) + 4 * B * H * (R + Rr) + 4 * B * pp
                   + 4 * B + 4 * B * H * R),
            flops=tokens * H * (2 * (R + Rr) + 2 * R)))
    return ops.paged_mla_decode, cases, tol


# paged_gqa_decode's rows: (heads, KV heads, pool storage, contexts).
# qwen3-14b (G = 5) as the table's row, its bf16 pool and one slot at 2048;
# then the other served GQA paths' decode, four slots at 600-1500 on an fp8
# pool: qwen1.5-4b (G = 1), yi-34b (G = 7, the kernel's runtime-G branch),
# qwen3-moe-30b-a3b (G = 8) and glm4-9b (G = 16, runtime G), and
# seamless-m4t-large-v2's decoder (G = 1 at head_dim 64, the fifth field;
# 128 where a row has none)
GQA_ROWS = ((40, 8, "fp8", [600, 900, 1200, 1500]),
            (40, 8, "bf16", [600, 900, 1200, 1500]),
            (40, 8, "fp8", [2048]),
            (20, 20, "fp8", [600, 900, 1200, 1500]),
            (56, 8, "fp8", [600, 900, 1200, 1500]),
            (32, 4, "fp8", [600, 900, 1200, 1500]),
            (32, 2, "fp8", [600, 900, 1200, 1500]),
            (16, 16, "fp8", [600, 900, 1200, 1500], 64))


def bench_paged_gqa(torch, dev, gen):
    """The served GQA paths' decode attention (``GQA_ROWS``), hd 128 (64
    where the row says), page 8, 256 pages a slot (max_len 2048). Returns
    (op, cases, tolerance)."""
    from repro_torch.core import paged
    from repro_torch.kernels import registry
    from repro_torch.kernels.paged_attention import ops
    tol = 2e-5    # fp32 online vs full softmax, same exact dequantization
    page, pp = 8, 256
    cases = []
    for H, KV, storage, ctx, *rest in GQA_ROWS:
        hd = rest[0] if rest else 128
        scale = 1.0 / math.sqrt(hd)
        B = len(ctx)
        P = B * pp
        q = torch.randn(B, H, hd, generator=gen, device=dev)
        k = torch.randn(P + 1, page, KV, hd, generator=gen, device=dev)
        v = torch.randn(P + 1, page, KV, hd, generator=gen, device=dev)
        if storage == "fp8":
            k, ks = paged.quantize_vecs(k, vec_ndim=2)
            v, vs = paged.quantize_vecs(v, vec_ndim=2)
            k, v = k.view(torch.uint8), v.view(torch.uint8)
        else:                            # native pool: unit scales
            k, v = k.bfloat16(), v.bfloat16()
            ks = vs = None
        table = torch.randperm(P, generator=gen, device=dev).reshape(B, pp)
        qpos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32,
                            device=dev)
        tokens = sum(ctx)
        rps, S = ops.gqa_split_plan(B, KV, hd, k.element_size(), page, pp,
                                    registry.sm_count(dev))
        active = KV * sum(-(-c // rps) for c in ctx)
        cases.append(dict(
            args=(q, k, v, ks, vs, table.int(), qpos), scale=scale,
            pools=(1, 2, 3, 4), plan=(rps, S), active=active,
            partial=active * (H // KV) * (hd + 2) * 4,
            shape=f"B={B} H={H} KV={KV} (G={H // KV}) hd={hd} page={page} "
                  f"contexts={ctx} ({storage} pool)",
            row_bytes=tokens * (2 * KV * hd * k.element_size()
                                + (8 if storage == "fp8" else 0)),
            bytes=(tokens * (2 * KV * hd * k.element_size()
                             + (8 if storage == "fp8" else 0))
                   + 4 * B * H * hd + 4 * B * pp + 4 * B + 4 * B * H * hd),
            flops=tokens * H * hd * 4))
    return ops.paged_gqa_decode, cases, tol


def mla_ring(torch, dev, B, T, layout):
    """pos and qpos of four slots' rings: "full" (every row valid, a
    1024-token context), "ragged" (slot 0 empty, the others partly
    filled), "wrapped" (past one wrap: rows 0..w hold positions T..),
    "served" (the dense path's steady contexts, 600-900 valid rows, the
    rest empty) or "stale" (the same contexts, the rows past qpos holding
    larger positions, as a slot's earlier occupant leaves them)."""
    t = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    if layout == "wrapped":
        w = 300 + 100 * torch.arange(B, dtype=torch.int32, device=dev)
        return torch.where(t <= w[:, None], t + T, t), w + T
    if layout == "ragged":
        lens = torch.tensor([0, 250, 500, 750][:B], dtype=torch.int32,
                            device=dev)
        return torch.where(t < lens[:, None], t, -1), (lens - 1).clamp_min(0)
    if layout in ("served", "stale"):
        ctx = torch.tensor(DSV3_PROMPTS["steady"][:B], dtype=torch.int32,
                           device=dev)
        pos = t if layout == "stale" else torch.where(t < ctx[:, None], t, -1)
        return pos.contiguous(), ctx - 1
    return t.contiguous(), torch.full((B,), T - 1, dtype=torch.int32,
                                      device=dev)


def bench_mla_decode(torch, dev, gen):
    """DeepSeek-V3's dense decode attention: four slots, 128 heads, R =
    512, Rr = 64, rings of T = 1024 (bf16 at published width: the table's
    row; the fp32 cache of the smoke width at the same shape), a ragged T
    with an empty slot, a wrapped ring, the dense path's served contexts
    and stale rows past qpos. Each row timed in a CUDA graph (warm and
    cold) and eagerly, with its split plan. Returns (op, cases,
    tolerance)."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.mla_attention import ops
    tol = 2e-5    # fp32 online vs full softmax; cache values exact in fp32
    B, H, R, Rr = 4, 128, 512, 64
    scale = 1.0 / math.sqrt(192)
    hg = ops.MLA_HEADS_PER_CTA
    groups = -(-H // hg)
    cases = []
    for T, layout, dt in ((1024, "full", torch.bfloat16),
                          (1024, "full", torch.float32),
                          (1000, "ragged", torch.bfloat16),
                          (1024, "wrapped", torch.bfloat16),
                          (1024, "served", torch.bfloat16),
                          (1024, "stale", torch.bfloat16)):
        qa = torch.randn(B, H, R, generator=gen, device=dev)
        qr = torch.randn(B, H, Rr, generator=gen, device=dev)
        ckv = torch.randn(B, T, R, generator=gen, device=dev).to(dt)
        kr = torch.randn(B, T, Rr, generator=gen, device=dev).to(dt)
        pos, qpos = mla_ring(torch, dev, B, T, layout)
        valid = (pos >= 0) & (pos <= qpos[:, None])
        nvalid = int(valid.sum())
        rps, S = ops.ring_split_plan(B, H, T, registry.sm_count(dev))
        per_split = torch.nn.functional.pad(valid, (0, rps * S - T))
        active = groups * int(per_split.reshape(B, S, rps).any(-1).sum())
        esize = ckv.element_size()
        args = (qa, qr, ckv, kr, pos, qpos)

        def lib(ref, a=args, v=valid):
            return sdpa_mla_ms(torch, *a[:4], v, scale, ref)
        cases.append(dict(
            args=args, scale=scale, pools=(2, 3, 4), what="rings",
            plan=(rps, S), active=active, eager=True,
            partial=active * hg * R * 4 + B * groups * S * hg * 2 * 4,
            shape=f"B={B} H={H} R={R} Rr={Rr} T={T} {layout} rings, "
                  f"{str(dt).split('.')[-1]} cache",
            row_bytes=nvalid * (R + Rr) * esize,
            bytes=(nvalid * (R + Rr) * esize + 4 * B * T
                   + 4 * B * H * (R + Rr) + 4 * B + 4 * B * H * R),
            flops=nvalid * H * (2 * (R + Rr) + 2 * R),
            zero_slots=[b for b in range(B) if not bool(valid[b].any())],
            library=lib if layout == "full" else None))
    return ops.mla_decode, cases, tol


def sdpa_mla_ms(torch, qa, qr, ckv, kr, valid, scale, ref):
    """scaled_dot_product_attention as the yardstick of mla_decode: q =
    [q_abs; q_rope] (B,H,1,576), K = [ckv; kr] and V = ckv over every head,
    a boolean mask of the valid rows, in fp32 (the kernel's arithmetic).
    None (reported as null) if it refuses or computes another function.
    The port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H = qa.shape[:2]
    T = ckv.shape[1]
    q = torch.cat([qa, qr], dim=-1)[:, :, None]
    k = torch.cat([ckv, kr], dim=-1).float()[:, None].expand(B, H, T, -1)
    v = ckv.float()[:, None].expand(B, H, T, -1)
    mask = valid[:, None, None, :]

    def lib():
        return sdpa(q, k, v, attn_mask=mask, scale=scale)
    try:
        out = lib()[:, :, 0]
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"[b]   library: scaled_dot_product_attention refused: "
            f"{str(e).splitlines()[0][:160]}")
        return None
    _, rel = max_err(torch, out, ref)
    if rel > 1e-3:
        log(f"[b]   library: scaled_dot_product_attention computes another "
            f"function (rel err {rel:.3g}); not a yardstick")
        return None
    log(f"[b]   library: scaled_dot_product_attention differs from the "
        f"plain version by {rel:.3g} of max|plain|")
    return cuda_ms(torch, lib, 20)


# flash_prefill's bucket rows: (S = T, heads, KV heads): qwen3-14b's 2048
# bucket (the table's row), its 512 and 128 buckets, and the 2048 bucket of
# glm4-9b (G = 16), qwen1.5-4b (G = 1), qwen3-moe-30b-a3b (G = 8) and
# yi-34b (G = 7); then seamless-m4t-large-v2's decoder (16 over 16 at
# head_dim 64, the fourth field; 128 where a row has none) and
# llama-3.2-vision-90b's self blocks (64 over 8)
FLASH_ROWS = ((2048, 40, 8), (512, 40, 8), (128, 40, 8), (2048, 32, 2),
              (2048, 20, 20), (2048, 32, 4), (2048, 56, 8),
              (2048, 16, 16, 64), (2048, 64, 8))


def bench_flash_prefill(torch, dev, gen):
    """The served prefill attention (``FLASH_ROWS``, hd 128 or the row's)
    and qwen3-14b's prefill chunk (S = 256 queries at positions 1280-1535
    against T = 2048 keys), each against SDPA."""
    from repro_torch.kernels.flash_attention import ops
    # per output row, relative to the row's own norm: P rounded to bf16
    # for P·V moves a row by ~2^-9 of itself; a key dropped from a row of
    # 2048 moves it by ~1/sqrt(2048) = 2e-2
    tol = 1e-2
    rows = []
    for S, H, KV, *rest in FLASH_ROWS:
        hd = rest[0] if rest else 128
        scale = 1.0 / math.sqrt(hd)
        q = torch.randn(1, S, H, hd, generator=gen, device=dev).bfloat16()
        k = torch.randn(1, S, KV, hd, generator=gen, device=dev).bfloat16()
        v = torch.randn(1, S, KV, hd, generator=gen, device=dev).bfloat16()
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(1, S)
        args = (q, k, v, pos, pos)
        y = ops.flash_prefill(*args, causal=True, scale=scale)
        ref = ops.flash_prefill.run_plain(*args, causal=True, scale=scale)
        err, _ = max_err(torch, y, ref)
        rel = max_row_err(torch, y, ref)
        check(f"flash_prefill (S = {S}, {H} heads over {KV}, hd {hd})", rel,
              tol, of="its row's norm")
        iters = 20 if S >= 2048 else 100
        ms = cuda_ms(torch, lambda: ops.flash_prefill(*args, causal=True,
                                                      scale=scale), iters)
        plain = cuda_ms(torch, lambda: ops.flash_prefill.run_plain(
            *args, causal=True, scale=scale), 3)
        # yardstick: SDPA over K/V repeated to H heads (no row is empty in
        # bucketed prefill, so it computes the same function here)
        G = H // KV
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib():
            return sdpa(qt, kt, vt, is_causal=True, scale=scale)
        lib_rel = max_row_err(torch, lib().transpose(1, 2), ref)
        lib_ms = cuda_ms(torch, lib, iters)
        log(f"[b]   flash_prefill S = T = {S}, H = {H}, KV = {KV}, hd = "
            f"{hd}: kernel "
            f"{ms:.4f} ms, SDPA "
            f"{lib_ms:.4f} ms (differs from the plain version by "
            f"{lib_rel:.3g} of a row's norm): kernel / SDPA = "
            f"{ms / lib_ms:.3f}")
        pairs = S * (S + 1) // 2                 # causal (row, key) pairs
        nbytes = (2 * S * H * hd + 2 * 2 * S * KV * hd + 4 * 2 * S
                  + 4 * S * H * hd)
        b, by = bound_ms(nbytes, 4 * hd * H * pairs, "bf16")
        rows.append(dict(
            shape=f"B=1 S=T={S} H={H} KV={KV} hd={hd} bf16 causal",
            max_abs_err=err, rel_err=rel, rel_of="a row's norm", tol=tol,
            ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=lib_ms))
        del args, q, k, v, y, ref, qt, kt, vt
    rows.append(bench_flash_chunk(torch, dev, gen, tol))
    return rows


# qwen3-14b's prefill chunk: C queries at positions [CHUNK_START, +C)
# against every row of a max_len slot
CHUNK_C, CHUNK_START, CHUNK_T = 256, 1280, 2048


def bench_flash_chunk(torch, dev, gen, tol):
    """flash_prefill at qwen3-14b's chunk shape: q (1, 256, 40, 128) bf16
    at positions 1280-1535, k and v (1, 2048, 8, 128) at positions
    0-2047, causal; most key blocks lie wholly above every query. SDPA
    takes K and V repeated to 40 heads and a boolean mask."""
    from repro_torch.kernels.flash_attention import ops
    H, KV, hd = 40, 8, 128
    S, T, start = CHUNK_C, CHUNK_T, CHUNK_START
    scale = 1.0 / math.sqrt(hd)
    q = torch.randn(1, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(1, T, KV, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(1, T, KV, hd, generator=gen, device=dev).bfloat16()
    qp = torch.arange(start, start + S, dtype=torch.int32, device=dev)[None]
    kp = torch.arange(T, dtype=torch.int32, device=dev)[None]
    args = (q, k, v, qp, kp)
    y = ops.flash_prefill(*args, causal=True, scale=scale)
    ref = ops.flash_prefill.run_plain(*args, causal=True, scale=scale)
    err, _ = max_err(torch, y, ref)
    rel = max_row_err(torch, y, ref)
    check("flash_prefill (chunk)", rel, tol, of="its row's norm")
    ms = cuda_ms(torch, lambda: ops.flash_prefill(*args, causal=True,
                                                  scale=scale), 100)
    plain = cuda_ms(torch, lambda: ops.flash_prefill.run_plain(
        *args, causal=True, scale=scale), 3)
    G = H // KV
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = (kp[0][None, :] <= qp[0][:, None])[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return sdpa(qt, kt, vt, attn_mask=mask, scale=scale)
    lib_rel = max_row_err(torch, lib().transpose(1, 2), ref)
    lib_ms = cuda_ms(torch, lib, 100)
    valid = int(mask.sum())                  # (row, key) pairs: Σ (pos + 1)
    nbytes = 2 * S * H * hd + 2 * 2 * T * KV * hd + 4 * (S + T) \
        + 4 * S * H * hd
    b, by = bound_ms(nbytes, 4 * hd * H * valid, "bf16")
    tiles = -(-S // 128) * H
    log(f"[b]   flash_prefill chunk S = {S} at {start}-{start + S - 1}, T = "
        f"{T}: kernel {ms:.4f} ms, SDPA (boolean mask) {lib_ms:.4f} ms "
        f"(differs from the plain version by {lib_rel:.3g} of a row's "
        f"norm): kernel / SDPA = {ms / lib_ms:.3f}; {valid} valid pairs, "
        f"bound {b:.4f} ms ({by}); {tiles} query tiles of 128 rows on "
        f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs")
    del args, q, k, v, y, ref, qt, kt, vt
    return dict(shape=f"B=1 S={S} at {start}-{start + S - 1}, T={T} H={H} "
                      f"KV={KV} hd={hd} bf16 causal (a prefill chunk)",
                max_abs_err=err, rel_err=rel, rel_of="a row's norm", tol=tol,
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=lib_ms)


# the compressed ring's hop chunk: a DeepSeek-V3 dense w1 gradient (7168 x
# 18432 fp32) split over 4 ranks
RING_SHAPE = (7168, 18432)
RING_WORLD = 4
RING_BITS = (8, 10)


def logfmt_bytes(N, D, n_bits):
    """Bytes one LogFMT pass moves: fp32 values, codes, fp32 sideband."""
    return N * D * 4 + N * D * (1 if n_bits <= 8 else 2) + 8 * N * D // 128


def time_logfmt(torch, dev, gen):
    """The LogFMT pair at the ring's hop chunk, (1792, 18432) fp32, at 8 and
    10 bits, timed before any plain version runs (after an fp32 plain
    version every kernel runs up to a fifth slower): in a CUDA graph of 20
    calls, eagerly, and the wrappers' host us per eager call. Decode reads
    the kernel's codes. Returns x and {op: [timing per width]}."""
    from repro_torch.kernels.logfmt import ops
    N, D = RING_SHAPE[0] // RING_WORLD, RING_SHAPE[1]
    x = torch.randn(N, D, generator=gen, device=dev)
    out = {"logfmt_encode": [], "logfmt_decode": []}
    for n_bits in RING_BITS:
        codes, mn, step = ops.logfmt_encode(x, n_bits=n_bits)
        calls = {"logfmt_encode": lambda: ops.logfmt_encode(x, n_bits=n_bits),
                 "logfmt_decode": lambda: ops.logfmt_decode(
                     codes, mn, step, n_bits=n_bits, dtype=torch.float32)}
        for name, fn in calls.items():
            t = dict(ms=graph_ms(torch, [fn] * 20), eager_ms=cuda_ms(
                torch, fn, 20))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            t["host_us"] = 1e6 * (time.perf_counter() - t0) / 100
            torch.cuda.synchronize()
            out[name].append(t)
        del codes, mn, step
    return x, out


def check_logfmt_edge_tiles(torch, dev):
    """The edge tiles of ``kernels/logfmt/edge.py`` (fp32) at 2, 3, 8, 10
    and 16 bits: codes equal to the plain version's on every structured
    tile (subnormals, the clamp, the step's floor and both sides of the
    estimate path's line), one level apart on under 0.1% of all."""
    from repro_torch.kernels.logfmt import edge, ops
    x, names = edge.edge_tiles()
    x = torch.from_numpy(x).to(dev)
    k = len(edge.STRUCTURED)
    for n_bits in (2, 3, 8, 10, 16):
        codes, mn, step = ops.logfmt_encode(x, n_bits=n_bits)
        rc, rmn, rstep = ops.logfmt_encode.run_plain(x, n_bits=n_bits)
        bad = [names[i] for i in range(k) if not torch.equal(codes[i], rc[i])]
        diff = codes.to(torch.int32) - rc.to(torch.int32)
        if bad or not (float((diff != 0).float().mean()) < 1e-3
                       and int(diff.abs().max()) <= 1):
            raise AssertionError(f"logfmt_encode {n_bits} bits, edge tiles: "
                                 f"structured tiles {bad} differ from the "
                                 "plain version's codes")
        torch.testing.assert_close(mn, rmn, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(step, rstep, rtol=1e-5, atol=1e-5)
    log(f"[b]   logfmt_encode edge tiles ({len(names)}: {', '.join(names)}) "
        "at 2, 3, 8, 10 and 16 bits: the structured tiles' codes equal the "
        "plain version's")


def bench_logfmt_encode(torch, dev, x, timed):
    """The ring hop's encode, timed by ``time_logfmt``, held against its
    plain version. Tolerance as the reference holds its kernel: codes one
    level apart on under 0.1% of entries, mn within rtol 1e-5 / atol 1e-6,
    step within rtol 1e-5 / atol 1e-5."""
    from repro_torch.kernels.logfmt import ops
    N, D = x.shape
    rows = []
    for n_bits, t in zip(RING_BITS, timed):
        codes, mn, step = ops.logfmt_encode(x, n_bits=n_bits)
        rc, rmn, rstep = ops.logfmt_encode.run_plain(x, n_bits=n_bits)
        diff = codes.to(torch.int32) - rc.to(torch.int32)
        off = float((diff != 0).float().mean())
        if not (off < 1e-3 and int(diff.abs().max()) <= 1):
            raise AssertionError(
                f"logfmt_encode {n_bits} bits: {off:.3g} of the codes differ"
                f" (max {int(diff.abs().max())} levels) from the plain "
                "version's; tolerance under 0.1%, one level")
        torch.testing.assert_close(mn, rmn, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(step, rstep, rtol=1e-5, atol=1e-5)
        err = max(float((mn - rmn).abs().max()),
                  float((step - rstep).abs().max()))
        plain = cuda_ms(torch, lambda: ops.logfmt_encode.run_plain(
            x, n_bits=n_bits), 3)
        # bytes: x read once, codes and sideband written once; operations:
        # the reference's three transcendentals a value (a log, two exps)
        # at the SFU rate, under the byte time at both widths (the kernel
        # itself evaluates one lg2.approx a value, two expf for the few
        # values its error bound leaves open, and two logf a tile)
        b, by = bound_ms(logfmt_bytes(N, D, n_bits), 3 * N * D, "sfu")
        rows.append(dict(shape=f"N={N} D={D} fp32, {n_bits} bits",
                         max_abs_err=err, rel_err=off, tol=1e-3,
                         rel_of="codes (one level apart)", plain_ms=plain,
                         bound_ms=b, bound_by=by, library_ms=None, **t))
        del codes, mn, step, rc, rmn, rstep, diff
    check_logfmt_edge_tiles(torch, dev)
    return rows


def bench_logfmt_decode(torch, dev, x, timed):
    """The ring hop's decode to fp32 of the kernel's codes of x at 8 and 10
    bits, timed by ``time_logfmt``. Tolerance: allclose(rtol 1e-4, atol
    1e-5), the reference's."""
    from repro_torch.kernels.logfmt import ops
    N, D = x.shape
    rows = []
    for n_bits, t in zip(RING_BITS, timed):
        codes, mn, step = ops.logfmt_encode(x, n_bits=n_bits)
        kw = dict(n_bits=n_bits, dtype=torch.float32)
        y = ops.logfmt_decode(codes, mn, step, **kw)
        ref = ops.logfmt_decode.run_plain(codes, mn, step, **kw)
        d = (y - ref).abs()
        rel = float((d / (1e-5 + 1e-4 * ref.abs())).max())
        check(f"logfmt_decode {n_bits} bits", rel, 1.0,
              of="the allclose bound")
        plain = cuda_ms(torch, lambda: ops.logfmt_decode.run_plain(
            codes, mn, step, **kw), 3)
        b, by = bound_ms(logfmt_bytes(N, D, n_bits), N * D, "sfu")
        rows.append(dict(shape=f"N={N} D={D} to fp32, {n_bits} bits",
                         max_abs_err=float(d.max()), rel_err=rel, tol=1.0,
                         rel_of="allclose(rtol 1e-4, atol 1e-5)",
                         plain_ms=plain, bound_ms=b, bound_by=by,
                         library_ms=None, **t))
        del codes, mn, step, y, ref, d
    return rows


def phase_kernels(torch):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the split-KV decode kernels and the LogFMT pair first: all five are
    # timed before any plain version runs (right after an fp32 plain
    # version everything runs up to a fifth slower; kernels/moe_gemm/
    # probe.py), then checked
    split = {"paged_mla_decode": bench_paged_mla(torch, dev, gen),
             "paged_gqa_decode": bench_paged_gqa(torch, dev, gen),
             "mla_decode": bench_mla_decode(torch, dev, gen)}
    for op, cases, _ in split.values():
        time_split_rows(torch, op, cases)
    ring_x, logfmt = time_logfmt(torch, dev, gen)
    split = {name: check_split_rows(torch, op, cases, tol)
             for name, (op, cases, tol) in split.items()}
    torch.cuda.empty_cache()
    out = {"fp8_gemm": bench_fp8_gemm(torch, dev, gen),
           "moe_gemm": bench_moe_gemm(torch, dev, gen),
           **split,
           "flash_prefill": bench_flash_prefill(torch, dev, gen),
           "logfmt_encode": bench_logfmt_encode(
               torch, dev, ring_x, logfmt["logfmt_encode"]),
           "logfmt_decode": bench_logfmt_decode(
               torch, dev, ring_x, logfmt["logfmt_decode"])}
    del ring_x
    for name, rows in out.items():
        for r in rows:
            lib = ("null" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            log(f"[b] {name} {r['shape']}: max_abs_err {r['max_abs_err']:.3g}"
                f" (rel {r['rel_err']:.3g} of {r.get('rel_of', 'max|plain|')}"
                f" <= tol {r['tol']:.3g}); kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} ms"
                + (f", cold L2 {r['cold_ms']:.4f} ms" if "cold_ms" in r
                   else "")
                + (f", eager {r['eager_ms']:.4f} ms" if "eager_ms" in r
                   else "")
                + (f", host {r['host_us']:.1f} us per eager call"
                   if "host_us" in r else ""))
    torch.cuda.empty_cache()
    return out


# --- (c) ---------------------------------------------------------------------


# each served path: its model and the overrides of its published config
# (DeepSeek-V3's depth cut), the engine's options, the kernels the path
# must launch and those it must not, its prompt lengths, max_len, and the
# four contexts of the steady decode
PAGED = dict(paged=True, page_storage="fp8", attn_impl="pallas")
RECURRENT = dict(paged=False, attn_impl="pallas")
DENSE = RECURRENT
# every op of the port's kernel registry
KERNEL_OPS = ("fp8_gemm", "moe_gemm", "paged_mla_decode", "paged_gqa_decode",
              "flash_prefill", "mla_decode", "logfmt_encode",
              "logfmt_decode")
DSV3_PROMPTS = dict(lengths=[16, 120, 250, 380, 490, 600], max_len=1024,
                    steady=[600, 700, 800, 900])
QWEN_PROMPTS = dict(lengths=[16, 200, 500, 900, 1200, 1500], max_len=2048,
                    steady=[600, 900, 1200, 1500])
# the paged paths also serve chunked (``chunked``): the same weights on a
# chunked-prefill engine (chunks of 256, page 8), its pool sized so the
# priority-5 arrival of the run must evict (``pool_pages``; see
# ``phase_chunked``), with each kernel's launches per prefill chunk; and
# phase (f) on the same weights: the host KV tier on qwen3-14b
# (``tier``), the gateway and the disaggregator on DeepSeek-V3
# (``gateway``)
PATHS = {
    "deepseek-v3-671b": dict(
        model="deepseek-v3-671b",
        overrides=dict(num_layers=4, fp8_impl="pallas"), engine=PAGED,
        kernels=("fp8_gemm", "moe_gemm", "paged_mla_decode"), absent=(),
        per_step={"paged_mla_decode": 4, "fp8_gemm": 29}, **DSV3_PROMPTS,
        chunked=dict(prefill_chunk=256, pool_pages=260,
                     per_chunk={"fp8_gemm": 29, "moe_gemm": 3}),
        gateway=True),
    "qwen3-14b": dict(
        model="qwen3-14b", overrides={}, engine=PAGED,
        kernels=("flash_prefill", "paged_gqa_decode"), absent=(),
        per_step={"paged_gqa_decode": 40}, **QWEN_PROMPTS,
        chunked=dict(prefill_chunk=256, pool_pages=600,
                     per_chunk={"flash_prefill": 40}),
        tier=True),
    "deepseek-v3-671b-dense": dict(
        model="deepseek-v3-671b",
        overrides=dict(num_layers=4, fp8_impl="pallas"),
        engine=dict(paged=False, use_mtp=True, attn_impl="pallas"),
        kernels=("fp8_gemm", "moe_gemm", "mla_decode"),
        absent=("paged_mla_decode",),
        per_step={"mla_decode": 4, "fp8_gemm": 38},
        **DSV3_PROMPTS),
    # the whole model at published widths, bf16 (30.53 B parameters): its
    # routed experts reach moe_gemm's bf16 format (fp8=False), 3 products
    # a MoE layer a step, each streaming all 128 experts
    "qwen3-moe-30b-a3b": dict(
        model="qwen3-moe-30b-a3b", overrides=dict(fp8_impl="pallas"),
        engine=PAGED, kernels=("flash_prefill", "paged_gqa_decode",
                               "moe_gemm"),
        absent=("fp8_gemm",),
        per_step={"paged_gqa_decode": 48, "moe_gemm": 144},
        **QWEN_PROMPTS,
        chunked=dict(prefill_chunk=256, pool_pages=600,
                     per_chunk={"flash_prefill": 48, "moe_gemm": 144})),
    # published widths, depth 48 -> 4: two dense/MoE pairs (35.29 B
    # parameters, 70.6 GB in bf16), top-1 routing plus the shared expert
    "llama4-maverick-400b-a17b": dict(
        model="llama4-maverick-400b-a17b",
        overrides=dict(num_layers=4, fp8_impl="pallas"), engine=PAGED,
        kernels=("flash_prefill", "paged_gqa_decode", "moe_gemm"),
        absent=("fp8_gemm",),
        per_step={"paged_gqa_decode": 4, "moe_gemm": 6}, **QWEN_PROMPTS),
    # published widths, depth cut to 8 layers each: the decode kernel's
    # G = 16 (runtime branch), 1 and 7 (runtime branch) on served paths
    "glm4-9b": dict(
        model="glm4-9b", overrides=dict(num_layers=8), engine=PAGED,
        kernels=("flash_prefill", "paged_gqa_decode"), absent=(),
        per_step={"paged_gqa_decode": 8}, **QWEN_PROMPTS),
    "qwen1.5-4b": dict(
        model="qwen1.5-4b", overrides=dict(num_layers=8), engine=PAGED,
        kernels=("flash_prefill", "paged_gqa_decode"), absent=(),
        per_step={"paged_gqa_decode": 8}, **QWEN_PROMPTS),
    "yi-34b": dict(
        model="yi-34b", overrides=dict(num_layers=8), engine=PAGED,
        kernels=("flash_prefill", "paged_gqa_decode"), absent=(),
        per_step={"paged_gqa_decode": 8}, **QWEN_PROMPTS),
    # the recurrent families, whole at published widths, bf16, on the dense
    # engine (they have no paged layout): no kernel of the port lies on
    # their paths (the reference dispatches none), so every op's launches
    # must stay 0. mamba2-2.7b: 64 SSD layers, qwen3-14b's prompts;
    # recurrentgemma-9b: 12 x (recurrent, recurrent, local attention) + 2
    # recurrent, window 2048: the 3000-token prompt wraps the windowed ring
    # in prefill, the 2040-token one during decode. ``steady``: the four
    # slots' contexts of the steady decode (recurrentgemma: past the
    # window, every ring row valid)
    "mamba2-2.7b": dict(
        model="mamba2-2.7b", overrides={}, engine=RECURRENT,
        kernels=(), absent=KERNEL_OPS, recurrent=True, **QWEN_PROMPTS),
    "recurrentgemma-9b": dict(
        model="recurrentgemma-9b", overrides={}, engine=RECURRENT,
        kernels=(), absent=KERNEL_OPS, recurrent=True,
        lengths=[16, 300, 1200, 2040, 2600, 3000], max_len=4096,
        steady=[2100, 2600, 3100, 3600]),
    # the families with a memory (``phase_memory_path``), each request
    # with its seeded extras (``memory``: frame rows a request, or the
    # patch count): seamless-m4t-large-v2 whole, bf16, on fp8 pages (its
    # max_len 2048 gives a 512-row memory leaf; frames of 64-512 rows);
    # llama-3.2-vision-90b at published widths cut 100 -> 10 layers (two
    # whole patterns), bf16, dense engine (no paged layout), its gates
    # drawn non-zero before serving. ``per_prefill``: each kernel's
    # launches a prefill (the decoder's or the self blocks' attention only:
    # the encoder and the cross-attention run the plain path, as the
    # reference's)
    "seamless-m4t-large-v2": dict(
        model="seamless-m4t-large-v2", overrides={}, engine=PAGED,
        kernels=("flash_prefill", "paged_gqa_decode"),
        absent=tuple(k for k in KERNEL_OPS
                     if k not in ("flash_prefill", "paged_gqa_decode")),
        per_step={"paged_gqa_decode": 24}, per_prefill={"flash_prefill": 24},
        memory=[64, 128, 256, 384, 448, 512], **QWEN_PROMPTS),
    "llama-3.2-vision-90b": dict(
        model="llama-3.2-vision-90b", overrides=dict(num_layers=10),
        engine=DENSE, kernels=("flash_prefill",),
        absent=tuple(k for k in KERNEL_OPS if k != "flash_prefill"),
        per_step={k: 0 for k in KERNEL_OPS}, per_prefill={"flash_prefill": 8},
        memory=[1601] * 6, **QWEN_PROMPTS),
}

# phase (d): each path's engine at smoke width, and qwen3-14b on the dense
# engine; the GQA paths' smoke widths keep their published query heads per
# KV head at head_dim 32 (qwen1.5-4b's smoke config has G = 1 already)
REFERENCE_CHECKS = [(p["model"], p["engine"]) for p in PATHS.values()] + [
    ("qwen3-14b", dict(paged=False, attn_impl="pallas"))] + [
    (p["model"], dict(p["engine"], prefill_chunk=8))
    for p in PATHS.values() if "chunked" in p] + [
    ("recurrentgemma-9b", RECURRENT, dict(num_layers=5))]
# the recurrent families' smoke prompts: past the smoke window of 32, so the
# windowed ring wraps in prefill (its decode of the 28-token one wraps too)
RECURRENT_SMOKE_LENGTHS = (28, 40, 50)
SMOKE_OVERRIDES = {"deepseek-v3-671b": {},
                   "mamba2-2.7b": {},
                   "recurrentgemma-9b": {},
                   "qwen3-14b": dict(num_heads=10, num_kv_heads=2),
                   "glm4-9b": dict(num_heads=32, num_kv_heads=2),
                   "qwen1.5-4b": {},
                   "yi-34b": dict(num_heads=14, num_kv_heads=2),
                   "qwen3-moe-30b-a3b": dict(num_heads=16, num_kv_heads=2),
                   "llama4-maverick-400b-a17b": dict(num_heads=10,
                                                     num_kv_heads=2),
                   "seamless-m4t-large-v2": {},
                   "llama-3.2-vision-90b": dict(num_heads=16,
                                                num_kv_heads=2)}


def path_config(name):
    from repro_torch.configs.base import get_config
    spec = PATHS[name]
    full = get_config(spec["model"])
    cfg = get_config(spec["model"], **spec["overrides"])
    heads = (f"{cfg.num_heads} MLA heads" if cfg.mla else
             f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads")
    if cfg.ssm:
        heads = (f"SSD: {cfg.ssm.num_heads(cfg.d_model)} heads of "
                 f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, conv "
                 f"{cfg.ssm.d_conv}")
    if cfg.rglru:
        heads += (f", RG-LRU width {cfg.rglru.lru_width}, pattern "
                  f"{cfg.rglru.pattern}, window {cfg.rglru.window}")
    moe = (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} "
           f"({cfg.moe.layout})" if cfg.moe else "")
    if cfg.encoder_layers:
        moe += (f", {cfg.encoder_layers} encoder layers, memory "
                f"{cfg.src_len_ratio} x max_len rows")
    if cfg.cross_attn_every:
        moe += (f", a gated cross-attention layer every "
                f"{cfg.cross_attn_every}, {cfg.num_patches} patches")
    log(f"[c] path {name}: {cfg.name}, {cfg.num_layers} of {full.num_layers} "
        f"layers at published widths (d_model {cfg.d_model}, {heads}, "
        f"d_ff {cfg.d_ff}{moe}, vocab {cfg.vocab_size}); fp8_impl="
        f"{cfg.fp8_impl}; engine {spec['engine']}; seeded random weights")
    return cfg


def serve_timed(eng, name, spec, reqs, extras=None):
    """Submit ``reqs`` (each with its ``extras``) and tick ``eng`` until it
    has no work, the launch counters zeroed just before. Gates: every
    request done with 32 in-vocabulary tokens, each kernel of the path
    launched, none of its absent ops, no page leaked. Returns (launch
    counts, TTFT s by request id at tick granularity, ticks, wall s)."""
    from repro_torch.kernels import registry
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        eng.submit(r, None if extras is None else extras[i])
    ttft, ticks = {}, 0
    while eng.has_work():
        eng.step()                       # ends in the per-chunk host sync
        ticks += 1
        now = time.perf_counter() - t0
        for r in reqs:
            if r.out and r.rid not in ttft:
                ttft[r.rid] = now
        if ticks > 200:
            raise AssertionError("main path did not finish in 200 ticks")
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    log(f"[c] launches on the {name} path: {counts}")
    for r in reqs:
        if not r.done or len(r.out) != 32:
            raise AssertionError(f"request {r.rid}: done={r.done}, "
                                 f"{len(r.out)} tokens (want 32)")
        if min(r.out) < 0 or max(r.out) >= eng.cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: token out of vocabulary")
    for k in spec["kernels"]:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the {name} "
                                 "path")
    for k in spec["absent"]:
        if counts[k]:
            raise AssertionError(f"kernel {k} launched on the {name} path")
    if eng.paged and eng.free_pages() != eng.pool_pages:
        raise AssertionError("pages leaked after every request finished")
    SERVED[name] = dict(prompts=[r.prompt.tolist() for r in reqs],
                        outs=[list(map(int, r.out)) for r in reqs])
    return counts, ttft, ticks, wall


def phase_main_path(torch, name):
    """Serve one model's path; returns the launch counts of its run."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine

    spec = PATHS[name]
    cfg = path_config(name)
    max_len = spec["max_len"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, slots=4, max_len=max_len, device="cuda", seed=0,
                      **spec["engine"])
    torch.cuda.synchronize()
    log(f"[c] engine up (weights drawn on the card, load-time preparation): "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    moe_layers = moe_layer_count(eng.model)
    if moe_layers:
        expert_storage(eng)

    rng = np.random.default_rng(0)
    lengths = spec["lengths"]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, L).astype(np.int32),
                    max_new=32) for i, L in enumerate(lengths)]
    counts, ttft, ticks, wall = serve_timed(eng, name, spec, reqs)
    if eng.use_mtp:
        drafts = eng.stats["drafts"]
        log(f"[c] MTP: {drafts} drafts, {eng.stats['accepted_drafts']} "
            f"accepted, acceptance rate {eng.acceptance_rate():.4f} (random "
            "weights: printed, not gated)")
        if drafts <= 0:
            raise AssertionError("the MTP path made no draft")
    ntok = sum(len(r.out) for r in reqs)
    log(f"[c] {len(reqs)} requests, prompts {lengths}, {ntok} tokens in "
        f"{wall:.3f} s over {ticks} ticks ({ntok / wall:.1f} tok/s end to "
        f"end); TTFT (at tick granularity) s: "
        f"{[round(ttft[r.rid], 3) for r in reqs]}")
    log(f"[c] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    check_graph(torch, eng, spec, reqs)

    # steady-state decode: four active slots at the path's contexts, each
    # on its own run of pages (paged) or with its ring filled to its
    # context (dense)
    model, params, cache = eng.model, eng.params, eng.cache
    steady_state(torch, eng, spec)
    steady_decode(torch, name, eng, spec, moe_layers)

    # prefill alone: the longest prompt, in its bucket
    from repro_torch.serve.engine import bucket_length
    p = reqs[-1].prompt
    bucket = bucket_length(len(p), max_len)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(p)] = p
    def prefill():
        return model.prefill(params, {"tokens": torch.as_tensor(toks)},
                             lengths=[len(p)])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    log(f"[c] prefill of a {len(p)}-token prompt (bucket {bucket}), 3 runs: "
        f"{[round(w, 2) for w in walls]} ms")
    profile_device(torch, f"{name} profile of that prefill", prefill, 1,
                   "prefill")

    # the output itself: finite logits of the right shape
    logits, _ = model.prefill(params, {"tokens": torch.as_tensor(
        reqs[0].prompt[None])})
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("main-path logits are not finite (1,1,V)")
    del logits
    if "chunked" in spec:
        phase_chunked(torch, name, eng, reqs)
    if spec.get("tier"):
        check_tier(torch, phase_tier(torch, eng))
        torch.cuda.empty_cache()
    if spec.get("gateway"):
        phase_gateway(torch, eng)
        phase_disagg(torch, eng)
    if name in MESH_STEP:
        SERVED[name].update(reference_logits(torch, eng, SERVED[name],
                                             spec["max_len"]))
        SERVED[name]["witness"] = witness(torch, eng, name, reqs)
    del eng, model, params, cache
    torch.cuda.empty_cache()
    return counts


# DeepSeek-V3's decode state a token: its bf16 MLA latent, (512 + 64) x 2 B
# x 61 layers (the paper's Table 1)
MLA_BYTES_PER_TOKEN = 70272


def flat_leaves(tree, path=()):
    """A nested dict of tensors as {key path: tensor}."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in flat_leaves(v, path + (k,)).items()}
    return {path: tree}


def recurrent_state(eng):
    """An engine's decode state by kind: the recurrent leaves (conv tails,
    SSD states, RG-LRU states) and the windowed rings' leaves."""
    leaves = flat_leaves({seg.name: eng.cache[seg.name]
                          for seg in eng.model.segments})
    rec = {p: t for p, t in leaves.items() if p[-1] in ("conv", "state",
                                                         "h")}
    rings = {p: t for p, t in leaves.items() if p not in rec}
    return rec, rings


def step_floor_bytes(eng):
    """The bytes a decode step of four slots must move at least: every
    weight once but the embedding table (four of its rows), the recurrent
    leaves read and written, the rings read."""
    params = flat_leaves({k: v for k, v in eng.params.items()
                          if isinstance(v, dict)})
    emb = params[("embed", "emb")]
    weights = (engine_bytes(params) - engine_bytes(emb)
               + 4 * emb.shape[1] * emb.element_size())
    rec, rings = recurrent_state(eng)
    return weights, 2 * engine_bytes(rec), engine_bytes(rings)


def steady_rings(torch, eng, spec):
    """Point every windowed ring of the four slots at the steady contexts:
    row t valid with the newest position p < context, p = t (mod rows)."""
    ctx = torch.tensor(spec["steady"], device=eng.device)[:, None]
    for path, ring in recurrent_state(eng)[1].items():
        if path[-1] != "pos":
            continue
        W = ring.shape[-1]
        t = torch.arange(W, device=eng.device)[None]
        src = t + torch.div(ctx - 1 - t, W, rounding_mode="floor") * W
        ring.copy_(torch.where(src >= 0, src, -1).int().expand_as(ring))


def phase_recurrent_path(torch, name):
    """Serve one recurrent family's path (mamba2-2.7b, recurrentgemma-9b)
    whole on the dense engine; returns the launch counts of its run. Gates:
    every request done with 32 in-vocabulary tokens, every op of the
    port's registry launched 0 times (the reference dispatches none for
    these families), no cache leaf's ``data_ptr`` moved over the run, the
    recurrent state leaves fp32, the decode chunk captured once and equal
    to the eager chunk (``check_graph``), finite logits of the right
    shape. Printed: tok/s, TTFT, graphed and eager ms a step against the
    step's byte floor, a profile of one graphed chunk, the longest
    prompt's prefill ms, peak memory, and the decode state's bytes a slot
    beside DeepSeek-V3's MLA latent at the same context."""
    import numpy as np
    from repro_torch.models.api import count_params
    from repro_torch.serve.engine import Request, ServeEngine, bucket_length

    spec = PATHS[name]
    cfg = path_config(name)
    max_len = spec["max_len"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, slots=4, max_len=max_len, device="cuda", seed=0,
                      **spec["engine"])
    torch.cuda.synchronize()
    log(f"[c] engine up (weights drawn on the card): "
        f"{time.perf_counter() - t0:.2f} s, {count_params(cfg)} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    rec, rings = recurrent_state(eng)
    log(f"[c] decode state of 4 slots: " + ", ".join(
        f"{'/'.join(p)} {tuple(t.shape)} {str(t.dtype)[6:]}"
        for p, t in {**rec, **rings}.items()))
    bad = [p for p, t in rec.items()
           if p[-1] in ("state", "h") and t.dtype != torch.float32]
    if bad or not any(p[-1] in ("state", "h") for p in rec):
        raise AssertionError(f"recurrent state leaves not fp32: {bad}")

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, L).astype(np.int32),
                    max_new=32) for i, L in enumerate(spec["lengths"])]
    ptrs = leaf_ptrs(eng.cache)
    counts, ttft, ticks, wall = serve_timed(eng, name, spec, reqs)
    if leaf_ptrs(eng.cache) != ptrs:
        raise AssertionError("a cache leaf was rebound over the served run")
    ntok = sum(len(r.out) for r in reqs)
    log(f"[c] {len(reqs)} requests, prompts {spec['lengths']}, {ntok} "
        f"tokens in {wall:.3f} s over {ticks} ticks ({ntok / wall:.1f} "
        f"tok/s end to end); TTFT (at tick granularity) s: "
        f"{[round(ttft[r.rid], 3) for r in reqs]}; every cache leaf kept "
        "its data_ptr")
    log(f"[c] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_graph(torch, eng, spec, reqs)

    # steady decode: the four slots at the path's contexts (the windowed
    # rings full), graphed and eager in turns, against the byte floor
    steady_rings(torch, eng, spec)
    host = steady_host(spec)
    chunk = eng._decode
    chunk(host)
    ms = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        ms[mode].append(chunk_ms(torch, chunk, host, mode == "graph"))
    w, st, rg = step_floor_bytes(eng)
    floor = 1e3 * (w + st + rg) / HBM_BYTES_PER_S
    log(f"[c] steady decode, 4 slots at contexts {spec['steady']} x "
        f"{chunk.k} steps, in turns (eager, graph, graph, eager): eager "
        f"{[round(x, 3) for x in ms['eager']]} ms/step, graphed "
        f"{[round(x, 3) for x in ms['graph']]} ms/step "
        f"({4e3 / min(ms['graph']):.1f} tok/s graphed); byte floor "
        f"{floor:.3f} ms ({w / 1e9:.3f} GB of weights read, "
        f"{st / 1e9:.3f} GB of recurrent state read and written, "
        f"{rg / 1e9:.3f} GB of rings read, at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): the graphed step is "
        f"{min(ms['graph']) / floor:.2f}x the floor")
    if leaf_ptrs(eng.cache) != ptrs:
        raise AssertionError("a cache leaf was rebound by the decode chunk")
    device_ms = profile_device(
        torch, f"{name} profile of one graphed {chunk.k}-step chunk",
        lambda: chunk(host), chunk.k, "step")
    if device_ms:
        log(f"[c] {name}: device ms a step under the profiler over the "
            f"unprofiled graphed ms/step ({min(ms['graph']):.3f}): "
            f"{100 * device_ms / min(ms['graph']):.1f}% busy")

    model, params = eng.model, eng.params
    p = reqs[-1].prompt
    bucket = bucket_length(len(p), max_len)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(p)] = p
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": torch.as_tensor(toks)},
                      lengths=[len(p)])
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    log(f"[c] prefill of a {len(p)}-token prompt (bucket {bucket}), 2 runs: "
        f"{[round(x, 2) for x in walls]} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the decode state a slot, beside DeepSeek-V3's latent at one context
    per_slot = (engine_bytes(rec) + engine_bytes(rings)) / eng.slots
    for c in sorted({len(p), max_len}):
        mla = MLA_BYTES_PER_TOKEN * c
        log(f"[c] {name}: decode state a slot {per_slot / 1e6:.3f} MB "
            f"({engine_bytes(rec) / eng.slots / 1e6:.3f} MB recurrent, "
            f"{engine_bytes(rings) / eng.slots / 1e6:.3f} MB of rings) "
            f"at any context; DeepSeek-V3's bf16 MLA latent at {c} tokens "
            f"{mla / 1e6:.3f} MB ({MLA_BYTES_PER_TOKEN} B a token): "
            f"{per_slot / mla:.3f}x; equal at "
            f"{per_slot / MLA_BYTES_PER_TOKEN:.0f} tokens")

    logits, _ = model.prefill(params, {"tokens": torch.as_tensor(
        reqs[0].prompt[None])})
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("main-path logits are not finite (1,1,V)")
    del logits, eng, model, params
    torch.cuda.empty_cache()
    return counts


# --- (c) the families with a memory -------------------------------------------


def memory_extras(torch, cfg, rows, seed):
    """A request's seeded extras on the card, bf16: frame embeddings (1,
    rows, d) of the enc-dec family, patch embeddings of the vision
    family."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    key = "src_embeds" if cfg.family == "encdec" else "patch_embeds"
    return {key: torch.randn((1, rows, cfg.d_model), generator=g,
                             device="cuda").to(torch.bfloat16)}


def draw_gates(torch, params, device):
    """The vision gates from a seeded normal, in place: their init is
    zeros, and tanh(0) would make every cross layer add nothing, so a
    broken cross-attention would pass every gate."""
    cross = params["pat"]["cross"]
    g = torch.Generator(device=device).manual_seed(13)
    for k in ("gate_attn", "gate_mlp"):
        cross[k].copy_(torch.randn(cross[k].shape, generator=g,
                                   device=device))
    return {k: [round(float(v), 4) for v in cross[k].float().cpu()]
            for k in ("gate_attn", "gate_mlp")}


def memory_floor(eng, spec):
    """The least a decode step of the steady slots costs: (weight bytes,
    K/V bytes, memory bytes, FLOPs). Bytes: every weight once but the
    embedding table (a row a slot), the self-attention K/V read at the
    contexts (E4M3 codes and scales on fp8 pages, bf16 rings otherwise),
    the memory leaf read. FLOPs: the cross-attention's K/V projection of
    every memory row, which the reference repeats every step (so does the
    port)."""
    cfg = eng.cfg
    slots = len(spec["steady"])
    params = flat_leaves({k: v for k, v in eng.params.items()
                          if isinstance(v, dict)})
    emb = params[("embed", "emb")]
    weights = (engine_bytes(params) - engine_bytes(emb)
               + slots * emb.shape[1] * emb.element_size())
    if cfg.family == "encdec":
        n_self = n_cross = cfg.num_layers
    else:
        n_cross = cfg.num_layers // cfg.cross_attn_every
        n_self = cfg.num_layers - n_cross
    kvd = cfg.num_kv_heads * cfg.head_dim_()
    per_tok = 2 * kvd * (1 if eng.paged and eng.page_storage == "fp8"
                         else 2) + (8 if eng.paged else 0)
    kv = sum(spec["steady"]) * n_self * per_tok
    mem = engine_bytes(eng.cache["memory"])
    rows = eng.cache["memory"].shape[1]
    flops = n_cross * slots * rows * 2 * 2 * cfg.d_model * kvd
    return weights, kv, mem, flops


def phase_memory_path(torch, name):
    """Serve one family with a memory (seamless-m4t-large-v2 on fp8 pages,
    llama-3.2-vision-90b on the dense engine), each request with its
    seeded extras; returns the launch counts of its run. Gates: every
    request done with 32 in-vocabulary tokens, each kernel of the path
    launched and no other op, no page leaked, no cache leaf's data_ptr
    moved (the memory leaf the decode graph reads among them), the decode
    chunk captured once and equal to the eager chunk (``check_graph``),
    the kernels' launches a step and a prefill, finite logits of the
    right shape. Printed: tok/s, TTFT, graphed and eager ms a step against
    the step's floor, profiles of a graphed chunk and of the longest
    prompt's prefill, its prefill ms, peak memory."""
    import numpy as np
    from repro_torch.kernels import registry
    from repro_torch.models.api import count_params
    from repro_torch.serve.engine import Request, ServeEngine, bucket_length

    spec = PATHS[name]
    cfg = path_config(name)
    max_len = spec["max_len"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, slots=4, max_len=max_len, device="cuda", seed=0,
                      **spec["engine"])
    gates = draw_gates(torch, eng.params, eng.device) \
        if cfg.family == "vlm" else None
    torch.cuda.synchronize()
    log(f"[c] engine up (weights drawn on the card): "
        f"{time.perf_counter() - t0:.2f} s, {count_params(cfg)} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; memory "
        f"leaf {tuple(eng.cache['memory'].shape)}"
        + (f"; gates drawn from a seeded normal: {gates}" if gates else ""))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, L).astype(np.int32),
                    max_new=32) for i, L in enumerate(spec["lengths"])]
    extras = [memory_extras(torch, cfg, n, 100 + i)
              for i, n in enumerate(spec["memory"])]
    ptrs = leaf_ptrs(eng.cache)
    counts, ttft, ticks, wall = serve_timed(eng, name, spec, reqs, extras)
    if leaf_ptrs(eng.cache) != ptrs:
        raise AssertionError("a cache leaf was rebound over the served run")
    ntok = sum(len(r.out) for r in reqs)
    log(f"[c] {len(reqs)} requests, prompts {spec['lengths']}, extras of "
        f"{spec['memory']} rows, {ntok} tokens in {wall:.3f} s over {ticks} "
        f"ticks ({ntok / wall:.1f} tok/s end to end); TTFT (at tick "
        f"granularity) s: {[round(ttft[r.rid], 3) for r in reqs]}; every "
        "cache leaf kept its data_ptr")
    log(f"[c] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_graph(torch, eng, spec, reqs, extras)

    steady_state(torch, eng, spec)
    graphed = steady_decode(torch, name, eng, spec, 0)
    w, kv, mem, flops = memory_floor(eng, spec)
    floor = 1e3 * (w + kv + mem) / HBM_BYTES_PER_S
    reproj = 1e3 * flops / PEAK_FLOPS["bf16"]
    log(f"[c] {name}: byte floor of a step {floor:.3f} ms ({w / 1e9:.3f} GB "
        f"of weights, {kv / 1e9:.4f} GB of K/V at contexts "
        f"{spec['steady']}, {mem / 1e9:.4f} GB of memory rows, at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), plus the cross-attention's K/V "
        f"re-projection of every memory row, {flops / 1e9:.1f} GFLOP: "
        f"{reproj:.3f} ms at the bf16 peak; the graphed step "
        f"{graphed:.3f} ms is {graphed / (floor + reproj):.2f}x their sum")

    model, params = eng.model, eng.params
    i = len(reqs) - 1
    p = reqs[i].prompt
    bucket = bucket_length(len(p), max_len)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(p)] = p

    def prefill():
        return model.prefill(params, dict(extras[i],
                                          tokens=torch.as_tensor(toks)),
                             lengths=[len(p)])
    registry.reset_launch_counts()
    prefill()
    once = {k: c for k, c in registry.launch_counts().items() if c}
    log(f"[c] launches of one prefill: {once}")
    if once != spec["per_prefill"]:
        raise AssertionError(f"a prefill launched {once}, want "
                             f"{spec['per_prefill']}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    log(f"[c] prefill of a {len(p)}-token prompt (bucket {bucket}) with "
        f"{spec['memory'][i]} rows of extras, 3 runs: "
        f"{[round(x, 2) for x in walls]} ms")
    profile_device(torch, f"{name} profile of that prefill", prefill, 1,
                   "prefill")
    logits, _ = model.prefill(params, dict(extras[0], tokens=torch.as_tensor(
        reqs[0].prompt[None])))
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("main-path logits are not finite (1,1,V)")
    log(f"[c] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del logits, eng, model, params, extras
    torch.cuda.empty_cache()
    return counts


def check_graph(torch, eng, spec, reqs, extras=None):
    """The decode chunk was captured once, and the same requests (with
    their ``extras``) on the same weights through an engine whose chunk
    runs eagerly give the same streams and, on the MTP path, the same draft
    and accept counts."""
    from repro_torch.serve.engine import Request, ServeEngine
    ch = eng._decode
    log(f"[c] decode graph: trace_counts {eng.trace_counts}; capture "
        f"{ch.capture_s:.3f} s + instantiation {ch.instantiate_s:.3f} s; "
        f"graph pool {ch.pool_bytes / 1e6:.1f} MB reserved; one replay "
        f"({ch.k} steps) launches {ch.tally} of the port's kernels")
    if eng.trace_counts != {"decode": 1, "chunk": 0}:
        raise AssertionError(f"trace_counts {eng.trace_counts}: want the "
                             "decode chunk captured once, no prefill chunk")
    ref = ServeEngine(eng.cfg, params=eng.params, slots=eng.slots,
                      max_len=eng.max_len, device=eng.device, seed=0,
                      **spec["engine"])
    ref._decode.graphed = False      # the eager chunk, the graph's oracle
    twins = [Request(r.rid, r.prompt, max_new=r.max_new, seed=r.seed)
             for r in reqs]
    t0 = time.perf_counter()
    for i, r in enumerate(twins):
        ref.submit(r, None if extras is None else extras[i])
    ref.run_until_done()
    wall = time.perf_counter() - t0
    same = sum(a.out == b.out for a, b in zip(reqs, twins))

    def mtp_counts(e):
        return e.stats["drafts"], e.stats["accepted_drafts"]
    log(f"[c] the same run with the eager chunk: {wall:.3f} s, "
        f"trace_counts {ref.trace_counts}; streams equal {same}/{len(reqs)}"
        + (f"; drafts, accepted: graphed {mtp_counts(eng)}, eager "
           f"{mtp_counts(ref)}" if eng.use_mtp else ""))
    if same != len(reqs) or mtp_counts(eng) != mtp_counts(ref):
        raise AssertionError("the graphed decode chunk disagrees with the "
                             "eager chunk")
    del ref


def steady_host(spec):
    """The chunk's host input for the steady decode: four active slots at
    the path's contexts, budgets that never run out, no EOS."""
    import numpy as np
    n = len(spec["steady"])
    zero = np.zeros(n, np.int64)
    return dict(tokens=zero, positions=np.asarray(spec["steady"]),
                active=np.ones(n, bool), left=zero + (1 << 20),
                eos=zero - 1, tix=zero, seeds=zero)


def chunk_ms(torch, chunk, host, graphed):
    """ms/step of one chunk, host input to host output (the engine's tick),
    replayed or eager."""
    chunk.graphed = graphed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(host)
    ms = 1e3 * (time.perf_counter() - t0) / chunk.k
    chunk.graphed = True
    return ms


def new_chunk(torch, model, params, cache, host, use_mtp):
    """A 4-slot decode chunk of 8 steps over ``cache``, run eagerly once
    and captured (and replayed) once."""
    from repro_torch.serve.graph import DecodeChunk
    chunk = DecodeChunk(model, params, cache, len(host["tokens"]), 8,
                        use_mtp=use_mtp)
    chunk(host)
    chunk(host)
    log(f"[c]   its graph: capture {chunk.capture_s:.3f} s + instantiation "
        f"{chunk.instantiate_s:.3f} s, pool {chunk.pool_bytes / 1e6:.1f} MB")
    return chunk


def steady_decode(torch, name, eng, spec, moe_layers):
    """Launches per step from one replay of the engine's graph (its tally
    counted once), the launch gates, ms/step graphed and eager in turns
    (with and without the draft on the MTP path), an eager and a graphed
    profile, and (dense, where the model pages) rings against a paged
    pool. Returns the least graphed ms a step."""
    from repro_torch.kernels import registry
    model, params, cache = eng.model, eng.params, eng.cache
    host = steady_host(spec)
    chunk = eng._decode
    k = chunk.k
    registry.reset_launch_counts()
    chunk(host)                                   # one replay: k steps
    counts = {n: c for n, c in registry.launch_counts().items() if c}
    log(f"[c] launches of one replay of the {k}-step graph: {counts}; per "
        f"decode step: { {n: c / k for n, c in counts.items()} }")
    want = dict(spec.get("per_step", {}))
    if moe_layers:
        want["moe_gemm"] = 3 * moe_layers         # 3 per MoE layer
    for n, c in want.items():
        if counts.get(n, 0) != k * c:
            raise AssertionError(f"a decode step launched {n} "
                                 f"{counts.get(n, 0) / k} times, want {c}")
    mtp = eng.use_mtp
    chunks, graph_ms = {mtp: chunk}, {}
    for use in ((True, False) if mtp else (False,)):
        if use not in chunks:
            log(f"[c] an {k}-step chunk without the draft, same cache:")
            chunks[use] = new_chunk(torch, model, params, cache, host, use)
        ms = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            ms[mode].append(chunk_ms(torch, chunks[use], host,
                                     mode == "graph"))
        log(f"[c] steady decode{' with the MTP draft' if use else ''}, 4 "
            f"slots at contexts {spec['steady']} x {k} steps, in turns "
            f"(eager, graph, graph, eager): eager "
            f"{[round(x, 3) for x in ms['eager']]} ms/step, graphed "
            f"{[round(x, 3) for x in ms['graph']]} ms/step "
            f"({4e3 / min(ms['graph']):.1f} tok/s graphed)")
        graph_ms[use] = min(ms["graph"])
    if moe_layers:
        # the capacity-buffer moe_gemm reads every expert of every MoE
        # layer each step: the expert wall over the card's memory rate is a
        # floor under the step
        from repro_torch import bridge
        wall = bridge.expert_storage(params)["bytes"]
        floor = 1e3 * wall / HBM_BYTES_PER_S
        log(f"[c] {name}: the expert wall ({wall / 1e9:.2f} GB over "
            f"{moe_layers} MoE layers) read once a step at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s is a floor of {floor:.3f} "
            f"ms; the graphed step {graph_ms[mtp]:.3f} ms is "
            f"{graph_ms[mtp] / floor:.2f}x that floor")
    st = model.init_decode_state(4)
    st["active"][:] = True
    st["positions"][:] = torch.tensor(spec["steady"], device=eng.device,
                                      dtype=torch.int32)
    st["left"][:] = 1 << 20
    profile_decode(torch, name, model, params, cache, st, use_mtp=mtp)
    device_ms = profile_device(
        torch, f"{name} profile of one graphed {k}-step chunk",
        lambda: chunk(host), k, "step")
    if device_ms:
        # the profiler's window outlasts the replay (its own start-up and
        # trace flush): the device time it records over the unprofiled
        # graphed tick of the same chunk is the tick's busy share
        log(f"[c] {name}: device ms a step under the profiler over the "
            f"unprofiled graphed ms/step ({graph_ms[mtp]:.3f}): "
            f"{100 * device_ms / graph_ms[mtp]:.1f}% busy")
    if not eng.paged and model.supports_paged():
        compare_layouts(torch, eng, spec, host, chunks[False])
    return graph_ms[mtp]


def moe_layer_count(model):
    """MoE layers of a model: its MoE segments' layers and one per
    dense/MoE pair (llama4's ``interleave:2``)."""
    return sum(seg.n for seg in model.segments
               if seg.kind in ("moe", "dense_moe"))


def expert_storage(eng):
    """Print how the engine stores its routed experts; on the FP8 path fail
    unless every matrix is E4M3 codes and scales (the load check kept none
    in the weight dtype), on a bf16 path unless none is. Returns the expert
    wall's bytes."""
    from repro_torch import bridge
    st = bridge.expert_storage(eng.params)
    kept = eng.params.get("plain_expert_matrices")
    log(f"[c] routed expert matrices: {st['e4m3']} as E4M3 codes + block "
        f"scales, {st['plain']} in the weight dtype ({kept} kept there by "
        f"the load check); expert wall {st['bytes'] / 1e9:.3f} GB")
    if eng.cfg.fp8 and (st["plain"] or kept or not st["e4m3"]):
        raise AssertionError("routed experts not all stored as E4M3 codes")
    if not eng.cfg.fp8 and (st["e4m3"] or not st["plain"]):
        raise AssertionError("a bf16 path's routed experts are not all "
                             "plain bf16 tensors")
    return st["bytes"]


def steady_state(torch, eng, spec):
    """Point the four slots at the steady contexts: each slot its own run
    of pages (paged), or rows 0..ctx-1 of every ring valid (dense, the MTP
    ring included)."""
    cache, dev = eng.cache, eng.device
    if eng.paged:
        pp = eng.pages_per_slot
        cache["page_table"].copy_(torch.arange(
            4 * pp, dtype=torch.int32, device=dev).reshape(4, pp))
        return
    ctx = torch.tensor(spec["steady"], device=dev)
    t = torch.arange(spec["max_len"], device=dev)
    pos = torch.where(t[None] < ctx[:, None], t[None], -1).int()
    def rings(tree):
        if "pos" in tree:
            return [tree]
        return [r for sub in tree.values() for r in rings(sub)]
    for ring in rings({seg.name: cache[seg.name]
                       for seg in eng.model.segments}) + (
            [cache["mtp"]] if "mtp" in cache else []):
        ring["pos"].copy_(pos.expand_as(ring["pos"]))


def compare_layouts(torch, eng, spec, host, dense):
    """Steady decode without the draft over the engine's dense rings
    (``dense``, its chunk) and, on the same model and weights, over a paged
    fp8 pool of 8-token pages (each slot its own run), in turns (dense,
    paged, paged, dense), eager and graphed."""
    model, params = eng.model, eng.params
    page = 8
    pp = spec["max_len"] // page
    pool = model.init_paged_cache(4, spec["max_len"], page, 4 * pp, "fp8")
    pool["page_table"].copy_(torch.arange(
        4 * pp, dtype=torch.int32, device=eng.device).reshape(4, pp))
    log(f"[c] an {dense.k}-step chunk over a paged fp8 pool, same weights:")
    chunks = {"dense": dense,
              "paged": new_chunk(torch, model, params, pool, host, False)}
    for mode in ("eager", "graph"):
        ms = {"dense": [], "paged": []}
        for layout in ("dense", "paged", "paged", "dense"):
            ms[layout].append(chunk_ms(torch, chunks[layout], host,
                                       mode == "graph"))
        log(f"[c] same weights, {mode}, in turns (dense, paged, paged, "
            f"dense), {dense.k} steps each: dense rings "
            f"{[round(x, 3) for x in ms['dense']]} ms/step, paged fp8 pool "
            f"{[round(x, 3) for x in ms['paged']]} ms/step")
    del chunks, pool


# --- (c) chunked prefill --------------------------------------------------------


# the chunked run's shared prefix and its three tails, in tokens
SHARED_PREFIX, SHARED_TAILS = 512, (40, 120, 200)


def first_diff(a, b):
    """Index of the first token where two streams differ, None if equal."""
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None and len(a) != len(b):
        i = min(len(a), len(b))
    return i


def chunked_engine(eng, spec):
    """A chunked-prefill engine on the weights ``eng`` already loaded and
    prepared (nothing is drawn or prepared again)."""
    from repro_torch.serve.engine import ServeEngine
    ch = spec["chunked"]
    return ServeEngine(eng.cfg, params=eng.params, slots=4,
                       max_len=spec["max_len"], device=eng.device, seed=0,
                       prefill_chunk=ch["prefill_chunk"],
                       pool_pages=ch["pool_pages"], **spec["engine"])


def drive(eng, limit=400):
    """Ticks until ``eng`` has no work; returns their count."""
    n = 0
    while eng.has_work():
        eng.step()
        n += 1
        if n > limit:
            raise AssertionError(f"the engine did not finish in {limit} "
                                 "ticks")
    return n


def phase_chunked(torch, name, eng, whole_reqs):
    """The path's chunked-prefill engine (same weights as ``eng``), one run
    with counters zeroed just before it: the path's six prompts; one
    request cancelled mid-prefill; three requests sharing a 512-token
    prefix (tails of 40, 120, 200), the last two submitted once the first
    has graduated; then three long residents and a priority-5 arrival the
    pool cannot take, which must evict. Gates (fatal): every request not
    cancelled finishes with its count of in-vocabulary tokens, the cancel
    returns True, no page leaks, prefix hits, an eviction whose victim
    finishes, one capture of each graph (``trace_counts``), exact launch
    counts (each kernel's launches per prefill chunk times the chunks,
    plus its launches per decode step times the steps), the shared streams
    equal to each request alone on a cold chunked engine, and a replayed
    prefill chunk equal to the eager chunk bit for bit (logits, pages and
    ``mtp_h``). Printed: the victim against an uninterrupted run, and the
    six streams against whole-prompt prefill's. Measured (``chunked_timing``):
    TTFT of the longest prompt chunked-graphed, chunked-eager and
    whole-prompt, in turns; ms per tick of three residents with and
    without that prompt streaming; ms per chunk graphed and eager; the
    chunk graph's capture and pool; syncs per chunk; a profile of one
    replayed chunk; peak memory."""
    import numpy as np
    from repro_torch.kernels import registry
    from repro_torch.serve.engine import Request
    spec = PATHS[name]
    ch = spec["chunked"]
    C, vocab, lengths = ch["prefill_chunk"], eng.cfg.vocab_size, \
        spec["lengths"]
    # the whole-prompt engine's steady decode pointed its rows at pages
    # of its own: back to the trash page before it serves again
    for slot in eng.free_slots():
        eng.model.release_slot_pages(eng.cache, slot)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ceng = chunked_engine(eng, spec)
    log(f"[c] path {name} chunked: ServeEngine(prefill_chunk={C}, page "
        f"{ceng.page_size}, pool_pages={ceng.pool_pages}, max_len="
        f"{ceng.max_len}, slots 4), the weights of the paged path")
    rng = np.random.default_rng(1)

    def prompt(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    six = [Request(r.rid, r.prompt, max_new=32) for r in whole_reqs]
    prefix = prompt(SHARED_PREFIX)
    shared = [Request(10 + i, np.concatenate([prefix, prompt(n)]),
                      max_new=32) for i, n in enumerate(SHARED_TAILS)]
    doomed = Request(20, prompt(lengths[3]), max_new=32)
    residents = [Request(30, prompt(lengths[-1]), max_new=64),
                 Request(31, prompt(lengths[-1]), max_new=32),
                 Request(32, prompt(lengths[-2]), max_new=32)]
    urgent = Request(40, prompt(lengths[2]), max_new=32, priority=5)
    everyone = six + shared + residents + [urgent]

    registry.reset_launch_counts()
    t0 = time.perf_counter()
    for r in six:
        ceng.submit(r)
    ticks = drive(ceng)
    ceng.submit(doomed)
    ceng.step()
    mid = [s for s, ps in ceng._prefilling.items() if ps["req"] is doomed]
    if not mid or not ceng.cancel(doomed.rid):
        raise AssertionError("cancel of a request mid-prefill failed")
    ceng.submit(shared[0])
    while not shared[0].out:
        ceng.step()
        ticks += 1
    for r in shared[1:]:
        ceng.submit(r)
    ticks += drive(ceng)
    for r in residents:
        ceng.submit(r)
    while not residents[0].out:
        ceng.step()
        ticks += 1
    need = ceng.pages_needed(urgent)
    if ceng.can_admit(urgent):
        raise AssertionError(f"the pool can take the priority-5 request "
                             f"({need} pages, {ceng.free_pages()} free): "
                             "it would not evict")
    log(f"[c] priority-5 request ({len(urgent.prompt)} + 32 tokens, {need} "
        f"pages) submitted with {ceng.free_pages()} of {ceng.pool_pages} "
        f"pages free and {len(ceng.free_slots())} slot(s) free")
    ceng.submit(urgent)
    ticks += drive(ceng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    chunks, steps = ceng.stats["chunk_prefills"], ceng._decode.k * \
        ceng._decode.calls
    log(f"[c] {name} chunked run: {len(everyone) + 1} requests, {chunks} "
        f"prefill chunks, {steps} decode steps ({ceng._decode.calls} "
        f"chunks) in {ticks} ticks, {wall:.3f} s wall; stats {ceng.stats}; "
        f"prefix_stats {ceng.prefix_stats()}; trace_counts "
        f"{ceng.trace_counts}; launches {counts}")
    log(f"[c] {name} chunked: peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for r in everyone:
        if not r.done or len(r.out) != r.max_new:
            raise AssertionError(f"chunked request {r.rid}: done={r.done}, "
                                 f"{len(r.out)} tokens (want {r.max_new})")
        if min(r.out) < 0 or max(r.out) >= vocab:
            raise AssertionError(f"chunked request {r.rid}: token out of "
                                 "vocabulary")
    if ceng.free_pages() != ceng.pool_pages:
        raise AssertionError("chunked engine: pages leaked")
    if ceng.prefix_stats()["hits"] <= 0:
        raise AssertionError("chunked engine: no prefix hit")
    if ceng.stats["evictions"] < 1:
        raise AssertionError("chunked engine: the priority-5 request "
                             "evicted nobody")
    if ceng.trace_counts != {"decode": 1, "chunk": 1}:
        raise AssertionError(f"chunked engine: trace_counts "
                             f"{ceng.trace_counts}, want one capture each")
    if ceng._prefill.calls != chunks:
        raise AssertionError(f"chunked engine: {ceng._prefill.calls} "
                             f"prefill chunks run, {chunks} counted")
    per_step = dict(spec["per_step"])
    moe_layers = moe_layer_count(ceng.model)
    if moe_layers:
        per_step["moe_gemm"] = 3 * moe_layers
    for k in spec["kernels"]:
        want = (ch["per_chunk"].get(k, 0) * chunks
                + per_step.get(k, 0) * steps)
        if counts[k] != want or not want:
            raise AssertionError(
                f"chunked {name}: {k} launched {counts[k]} times, want "
                f"{ch['per_chunk'].get(k, 0)} x {chunks} chunks + "
                f"{per_step.get(k, 0)} x {steps} decode steps = {want}")
    log(f"[c] {name} chunked gates held: launches = per chunk "
        f"{ch['per_chunk']} x {chunks} + per step {per_step} x {steps}; "
        f"one replay of the chunk graph launches {ceng._prefill.tally}")
    check_chunk_replay(torch, name, ceng, prompt(2 * C + C // 2))

    # cold engines: each shared request alone (bitwise, fatal); the victim
    # alone after the first (printed)
    victim = residents[0]
    for i, r in enumerate(shared):
        cold = chunked_engine(eng, spec)
        twin = Request(r.rid, r.prompt, max_new=r.max_new)
        cold.submit(twin)
        drive(cold)
        if twin.out != r.out:
            raise AssertionError(
                f"shared-prefix request {r.rid} differs from itself alone on "
                f"a cold engine at token {first_diff(twin.out, r.out)}")
        if i == 0:
            alone = Request(victim.rid, victim.prompt,
                            max_new=victim.max_new)
            cold.submit(alone)
            drive(cold)
            d = first_diff(alone.out, victim.out)
            log(f"[c] {name} chunked: the victim's stream "
                + ("equals an uninterrupted run" if d is None else
                   f"first differs from an uninterrupted run at token {d} "
                   "(its resume's first token comes from a prefill chunk, "
                   "not the decode kernel)")
                + " (printed, not gated)")
        del cold
        torch.cuda.empty_cache()
    log(f"[c] {name} chunked: the three shared-prefix streams equal each "
        "request alone on a cold chunked engine, bitwise")
    diffs = [first_diff(a.out, b.out) for a, b in zip(six, whole_reqs)]
    log(f"[c] {name}: chunked vs whole-prompt streams, same weights, first "
        f"differing token per request (None = equal; printed, not gated): "
        f"{diffs}")
    chunked_timing(torch, name, ceng, eng, len(whole_reqs[-1].prompt))
    del ceng
    torch.cuda.empty_cache()


def check_chunk_replay(torch, name, ceng, prompt):
    """A replayed prefill chunk equals the eager chunk bit for bit: the
    same prompt streamed through the engine's captured chunk graph and
    through an eager ``PrefillChunk`` on the same model, weights and cache,
    each into fresh pages of one free slot: every chunk's logits, every
    written page of every pool and the slot's ``mtp_h`` equal (fatal). The
    eager chunk is the one a prefix sharer's pages may come from."""
    import numpy as np
    from repro_torch.serve.graph import PrefillChunk
    C, L, page = ceng.prefill_chunk, len(prompt), ceng.page_size
    n = -(-L // page)
    slot = ceng.free_slots()[0]
    eager = PrefillChunk(ceng.model, ceng.params, ceng.cache, C,
                         ceng.pages_per_slot)
    eager.graphed = False
    runs = {}
    for which, chunk in (("replay", ceng._prefill), ("eager", eager)):
        pages = ceng._alloc.alloc(n)
        row = np.full((ceng.pages_per_slot,), ceng.pool_pages, np.int32)
        row[:n] = pages
        logits = []
        for start in range(0, L, C):
            toks = np.zeros((C,), np.int32)
            toks[:min(L, start + C) - start] = prompt[start:start + C]
            logits.append(chunk(toks, start, L, slot, row).clone())
        torch.cuda.synchronize()
        written = [t[:, pages].clone() for seg in ceng.model.segments
                   for t in ceng.cache[seg.name].values()]
        if "mtp_h" in ceng.cache:
            written.append(ceng.cache["mtp_h"][slot].clone())
        runs[which] = (logits, written)
        ceng._alloc.release(pages)
    (la, wa), (lb, wb) = runs["replay"], runs["eager"]
    same_logits = all(torch.equal(a, b) for a, b in zip(la, lb))
    same_pages = all(torch.equal(a, b) for a, b in zip(wa, wb))
    log(f"[c] {name}: a {L}-token prompt ({len(la)} chunks) through the "
        f"replayed chunk graph and through the eager chunk: logits equal "
        f"{same_logits}, written pages{' and mtp_h' if 'mtp_h' in ceng.cache else ''} "
        f"equal {same_pages} (bit for bit)")
    if not (same_logits and same_pages):
        raise AssertionError("a replayed prefill chunk differs from the "
                             "eager chunk")
    if ceng.free_pages() != ceng.pool_pages:
        raise AssertionError("pages leaked by the replay check")


def ttft_run(torch, e, long_prompt, C):
    """Three residents decoding on ``e``, three ticks of theirs alone, then
    the long prompt submitted: its TTFT and every tick's ms until its first
    token. Then everything is cancelled (decoding requests). The residents'
    budget outlasts the run: a tick a chunk of ``C`` tokens of their
    16-token prompts, three alone, a tick a chunk of the long prompt, two
    to spare."""
    import numpy as np
    from repro_torch.serve.engine import Request
    new = e.chunk * (3 * -(-16 // C) + 3 + -(-len(long_prompt) // C) + 2)
    residents = [Request(100 + i, (np.arange(16) * (i + 7)) % 1000,
                         max_new=new) for i in range(3)]
    for r in residents:
        e.submit(r)
    while not all(r.out for r in residents) or e._prefilling:
        e.step()
    idle = []
    for _ in range(3):
        t0 = time.perf_counter()
        e.step()
        idle.append(1e3 * (time.perf_counter() - t0))
    lr = Request(99, long_prompt, max_new=32)
    t0 = time.perf_counter()
    e.submit(lr)
    ticks = []
    while not lr.out:
        t1 = time.perf_counter()
        e.step()
        ticks.append(1e3 * (time.perf_counter() - t1))
    ttft = 1e3 * (time.perf_counter() - t0)
    if not all(r.out and not r.done for r in residents):
        raise AssertionError("a resident stopped while the prompt streamed")
    for r in residents + [lr]:
        if not e.cancel(r.rid):
            raise AssertionError(f"cancel of decoding request {r.rid} failed")
    if e.free_pages() != e.pool_pages:
        raise AssertionError("pages leaked after cancelling every request")
    return ttft, idle, ticks


def chunk_ticks(torch, ceng, prompt, graphed):
    """Every tick of ``prompt`` alone on ``ceng`` (no decoding slot: a tick
    is one chunk, the last one reading its first token back), its chunk
    graphed or eager: host ms to return and wall ms to the device's end per
    chunk, the synchronising calls of each tick as
    ``torch.cuda.set_sync_debug_mode`` flags them, and their messages."""
    import warnings
    from repro_torch.serve.engine import Request
    ceng._prefill.graphed = graphed
    r = Request(98, prompt, max_new=32)
    ceng.submit(r)
    host, wall, syncs, said = [], [], [], set()
    while not r.out:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            ceng.step()
            t1 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        host.append(1e3 * (t1 - t0))
        wall.append(1e3 * (time.perf_counter() - t0))
        flagged = [str(w.message) for w in seen
                   if "synchroniz" in str(w.message)]
        syncs.append(len(flagged))
        said.update(m.splitlines()[0][:120] for m in flagged)
    ceng._prefill.graphed = True
    ceng.cancel(98)
    return host, wall, syncs, said


def chunked_timing(torch, name, ceng, eng, L):
    """TTFT of a prompt of the path's longest length with three residents
    decoding: chunked with the chunk graph, chunked with eager chunks (the
    same engine, its graph set aside) and whole-prompt (``eng``), in
    turns, 3 runs each; the residents' ms per tick with and without it;
    ms per chunk alone, graphed and eager in turns; the chunk graph's
    capture; a profile of one replayed chunk. Every run takes a prompt of
    its own, so no prefix hit shortens a chunked one."""
    import numpy as np
    from repro_torch.serve.engine import Request
    C = ceng.prefill_chunk
    pc = ceng._prefill
    log(f"[c] {name} chunk graph: trace_counts {ceng.trace_counts}; capture "
        f"{pc.capture_s:.3f} s + instantiation {pc.instantiate_s:.3f} s; "
        f"graph pool {pc.pool_bytes / 1e6:.1f} MB reserved; one replay "
        f"launches {pc.tally} of the port's kernels")
    rng = np.random.default_rng(2)
    prompts = iter([rng.integers(0, eng.cfg.vocab_size, L).astype(np.int32)
                    for _ in range(14)])
    runs = {"graphed": [], "eager": [], "whole": []}
    order = ("graphed", "eager", "whole", "whole", "eager", "graphed",
             "graphed", "eager", "whole")
    for which in order:
        e = eng if which == "whole" else ceng
        pc.graphed = which != "eager"
        runs[which].append(ttft_run(torch, e, next(prompts), C))
        pc.graphed = True
    how = {"graphed": "one chunk replay + one decode replay",
           "eager": "one eager chunk + one decode replay",
           "whole": "prefill + admission + one decode replay"}
    for which, rs in runs.items():
        log(f"[c] {name} {which}: TTFT of a {L}-token prompt with 3 "
            f"residents decoding, 3 runs in turns: "
            f"{[round(t, 2) for t, _, _ in rs]} ms; the residents' ms per "
            f"tick without prefill "
            f"{[[round(x, 2) for x in i] for _, i, _ in rs]}, while it "
            f"streams ({how[which]} a tick) "
            f"{[[round(x, 2) for x in t] for _, _, t in rs]}")
    # chunks alone, graphed and eager in turns
    alone = {True: [], False: []}
    said = set()
    for graphed in (True, False, False, True):
        *r, msgs = chunk_ticks(torch, ceng, next(prompts), graphed)
        alone[graphed].append(r)
        said |= msgs
    for graphed, rs in alone.items():
        log(f"[c] {name} prefill chunks of {C} tokens alone, "
            f"{'graphed' if graphed else 'eager'}, 2 runs in turns (the "
            f"first tick with its admission, the last with the first "
            f"token's read-back and the first decode chunk): host ms to "
            f"return "
            f"{[[round(x, 2) for x in h] for h, _, _ in rs]}, wall ms to "
            f"the device's end {[[round(x, 2) for x in w] for _, w, _ in rs]}"
            f", synchronising calls a tick {[s for _, _, s in rs]}")
    log(f"[c] {name}: what the flagged calls said: {sorted(said)}")
    ceng.submit(Request(97, next(prompts), max_new=32))
    ceng.step()                                       # admission + chunk 1
    device = profile_device(torch, f"{name} profile of one replayed "
                            f"prefill chunk ({C} tokens at {C}-{2 * C - 1})",
                            ceng.step, 1, "chunk")
    ceng.cancel(97)
    if ceng.free_pages() != ceng.pool_pages:
        raise AssertionError("pages leaked after cancelling mid-prefill")
    if device:
        w = alone[True][0][1][1]
        log(f"[c] {name}: one graphed chunk's wall ms above its device ms: "
            f"{w - device:.2f} (unprofiled wall {w:.2f} ms of a chunk at "
            f"the same position, profiled device {device:.2f})")


# the port's kernels, as the profiler names them (checked in this order,
# so "paged_mla_decode" before "mla_decode", and before the library GEMM
# group, whose names also say "gemm")
KERNEL_GROUPS = ("fp8_gemm", "moe_gemm", "paged_mla_decode",
                 "paged_gqa_decode", "flash_prefill", "mla_decode")


def profile_decode(torch, name, model, params, cache, st, steps=2,
                   use_mtp=False):
    """Device time by kernel over ``steps`` decode steps."""
    profile_device(torch, f"{name} profile of {steps} decode steps",
                   lambda: model.decode_loop(params, cache, st, steps,
                                             use_mtp=use_mtp), steps, "step")


def profile_device(torch, label, fn, per, unit):
    """Device time by kernel group over one call of ``fn`` (torch.profiler,
    CUPTI), divided by ``per`` ``unit``s, and the device's busy share of
    the profiled window. Returns the device ms per ``unit`` (None when
    the profiler recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"[c] {label}: no device time recorded (not measured)")
        return None
    rows.sort(reverse=True)
    launched = sum(r[1] for r in rows) // per
    groups = {}
    group_of = {}
    for us, n, key in rows:
        g = next((k for k in KERNEL_GROUPS if k in key), None)
        if g is None:
            g = ("torch.matmul (cuBLAS)"
                 if any(w in key for w in ("gemm", "gemv", "nvjet", "xmma"))
                 else "other")
        groups[g] = groups.get(g, 0.0) + us
        group_of[key] = g
    log(f"[c] {label}: device busy {busy / 1e3:.2f} ms"
        f" of {wall_us / 1e3:.2f} ms wall ({100 * busy / wall_us:.1f}% busy "
        f"under the profiler), {launched} kernels per {unit}; per {unit} by "
        "kernel: " + ", ".join(
            f"{g} {v / 1e3 / per:.3f} ms ({100 * v / busy:.1f}%)"
            for g, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for us, n, key in rows[:14]:
        log(f"[c]   {us / 1e3 / per:8.3f} ms/{unit}  x{n // per:<4d} "
            f"{key[:90]}")
    # the split-KV kernels: each group holds its split and combine kernels;
    # fp8_gemm's its decode, reduce and prefill kernels
    for g in ("fp8_gemm", "paged_mla_decode", "paged_gqa_decode",
              "mla_decode"):
        if g in groups:
            log(f"[c]   group {g}: " + ", ".join(
                f"{key[:70]} x{n // per} {us / 1e3 / per:.3f} ms"
                for us, n, key in rows if group_of[key] == g))
    return busy / 1e3 / per


# --- (d) ---------------------------------------------------------------------


def phase_reference(torch, name, engine, overrides=None):
    import dataclasses

    import numpy as np
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.api import Model
    from repro_torch.serve.engine import Request, ServeEngine, bucket_length

    cfg = dataclasses.replace(
        smoke_config(get_config(name)), dtype="bfloat16",
        param_dtype="bfloat16", fp8_impl="pallas", **SMOKE_OVERRIDES[name],
        **(overrides or {}))
    params = Model(cfg, device="cpu").init(seed=1)
    if cfg.family == "vlm":
        draw_gates(torch, params, "cpu")
    lengths = (RECURRENT_SMOKE_LENGTHS if cfg.family in ("ssm", "hybrid")
               else (5, 12, 19))
    prompts = [np.arange(L) * (i + 3) % cfg.vocab_size
               for i, L in enumerate(lengths)]
    # the families with a memory: seeded frames (6, 13 and 16 rows of the
    # 16-row leaf at max_len 64) or patches, the same on both devices
    extras = [{}] * len(prompts)
    if cfg.family in ("encdec", "vlm"):
        key = "src_embeds" if cfg.family == "encdec" else "patch_embeds"
        extras = [{key: np.random.default_rng(20 + i).normal(size=(
            1, n if cfg.family == "encdec" else cfg.num_patches,
            cfg.d_model)).astype(np.float32)}
            for i, n in enumerate((6, 13, 16))]
    outs, logits, drafts, bf16_pages = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(cfg, params=params, slots=2, max_len=64, chunk=4,
                          device=dev, **engine)
        reqs = [Request(i, p, max_new=8) for i, p in enumerate(prompts)]
        for r, e in zip(reqs, extras):
            eng.submit(r, e or None)
        eng.run_until_done()
        outs[dev] = [r.out for r in reqs]
        drafts[dev] = (eng.stats["drafts"], eng.stats["accepted_drafts"])
        # the card's engine decodes (and prefills chunks) through its
        # graphs; the CPU's eagerly
        want = {"decode": int(dev == "cuda"),
                "chunk": int(dev == "cuda" and "prefill_chunk" in engine)}
        if eng.trace_counts != want:
            raise AssertionError(f"{dev} engine: trace_counts "
                                 f"{eng.trace_counts}, want {want}")
        if engine.get("prefill_chunk"):
            lg = chunk_logits(eng, prompts[2])
            bf16_pages[dev] = chunk_logits(eng, prompts[2],
                                           "bf16").float().cpu()
        else:
            toks = np.zeros((1, bucket_length(len(prompts[2]), 64)),
                            np.int32)
            toks[0, :len(prompts[2])] = prompts[2]
            lg, _ = eng.model.prefill(
                eng.params, dict(extras[2], tokens=torch.as_tensor(toks)),
                lengths=[len(prompts[2])])
        logits[dev] = lg.float().cpu()
    a, b = logits["cuda"], logits["cpu"]
    rel = float((a - b).abs().max() / b.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(a.flatten(),
                                                      b.flatten(), dim=0))
    same = sum(x == y for o1, o2 in zip(outs["cuda"], outs["cpu"])
               for x, y in zip(o1, o2))
    extra = (f"; MTP drafts/accepted card {drafts['cuda']}, CPU "
             f"{drafts['cpu']}" if engine.get("use_mtp") else "")
    how = ("Model.prefill_chunk" if engine.get("prefill_chunk")
           else "Model.prefill")
    if bf16_pages:
        a2, b2 = bf16_pages["cuda"], bf16_pages["cpu"]
        extra += (f"; the same logits on bf16 pages (printed, not gated): "
                  f"max err {float((a2 - b2).abs().max() / b2.abs().max()):.3g}")
    graphs = ("decode and prefill chunks one CUDA graph each"
              if engine.get("prefill_chunk") else "decode chunk one CUDA graph")
    log(f"[d] {name} {engine} at smoke width ({cfg.num_layers} layers, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads), bf16, the "
        f"card's {graphs}: "
        f"first-token logits ({how}) card vs CPU "
        f"plain: max err {rel:.3g} of max|logit| (tol 5e-2), cosine "
        f"{cos:.6f} (>= 0.999); greedy tokens equal {same}/24{extra}")
    if not (rel <= 5e-2 and cos >= 0.999):
        raise AssertionError("kernel path disagrees with the plain path on "
                             "the small input")
    if engine.get("use_mtp") and drafts["cuda"][0] != drafts["cpu"][0]:
        raise AssertionError("MTP draft counts differ between card and CPU")


def chunk_logits(eng, prompt, storage=None):
    """First-token logits of ``prompt`` through ``Model.prefill_chunk``,
    chunk by chunk, into a fresh pool of the engine's layout (slot 0's row
    on pages 0..), its page storage or ``storage``."""
    import numpy as np
    C, page = eng.prefill_chunk, eng.page_size
    pp = eng.max_len // page
    cache = eng.model.init_paged_cache(1, eng.max_len, page, pp,
                                       storage or eng.page_storage)
    row = np.arange(pp, dtype=np.int32)[None]
    L = len(prompt)
    for start in range(0, L, C):
        toks = np.zeros((1, C), np.int32)
        toks[0, :min(L, start + C) - start] = prompt[start:start + C]
        pos = np.arange(start, start + C, dtype=np.int32)[None]
        lg, _ = eng.model.prefill_chunk(eng.params, cache, toks, pos, [L],
                                        row, 0)
    return lg


# --- (e) ---------------------------------------------------------------------

# the card's ring against the same ring on the CPU ranks: per-member inputs
# from numpy seeds. "same-sign" draws each element's sign once for all
# members (|x| in [1, 2)), so no sum cancels and the two rings must agree
# element by element but for tie flips; "normal" is zero-mean, where a
# last-ulp difference in a near-zero sum moves its tile's whole log-domain
# grid at the next hop (printed, and held by its RMS error only)
RING_SMALL = (1024, 2048)


def ring_small_inputs(np, kind):
    g = np.random.default_rng([14, 0 if kind == "same-sign" else 1])
    shape = (RING_WORLD,) + RING_SMALL
    if kind == "normal":
        return g.standard_normal(shape).astype(np.float32)
    sign = np.where(g.random(RING_SMALL) < 0.5, -1.0, 1.0)
    return (sign * (1.0 + g.random(shape))).astype(np.float32)


def ring_rank(rank, store_path, out_path):
    """One rank of phase (e), in a spawned process: the compressed ring on
    the card at full size, then card against CPU at the small size; the
    results go to ``out_path`` as JSON. Raises (exit code 1) on any
    fault."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import registry
    from repro_torch.parallel.collectives import compressed_psum

    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", rank=rank, world_size=RING_WORLD,
                            store=dist.FileStore(store_path, RING_WORLD))

    def member(r):
        g = torch.Generator(device=dev)
        g.manual_seed(r)
        return torch.randn(RING_SHAPE, generator=g, device=dev)

    x = member(rank)
    res = {"rank": rank, "calls": {}, "small": {}}
    for n_bits in RING_BITS:
        dist.barrier()
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        y = compressed_psum(x, n_bits=n_bits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = registry.launch_counts()
        dist.barrier()
        t0 = time.perf_counter()
        compressed_psum(x, n_bits=n_bits)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        exact = torch.zeros_like(x)
        for r in range(RING_WORLD):             # regenerated one at a time
            exact += member(r)
        scale = float(exact.abs().max())
        res["calls"][str(n_bits)] = dict(
            launches=counts, shape=list(y.shape), dtype=str(y.dtype),
            finite=bool(torch.isfinite(y).all()),
            err=float((y - exact).abs().max()) / scale,
            wall_ms=1e3 * wall, warm_ms=1e3 * warm)
        del y, exact
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del x
    for kind in ("same-sign", "normal"):
        xs = ring_small_inputs(np, kind)
        exact = xs.astype(np.float64).sum(0)
        scale = float(np.abs(exact).max())
        for n_bits in RING_BITS:
            mine = torch.from_numpy(xs[rank])
            yc = compressed_psum(mine.to(dev), n_bits=n_bits).cpu().numpy()
            yp = compressed_psum(mine, n_bits=n_bits).numpy()
            rms = [float(np.sqrt(((y - exact) ** 2).mean())) / scale
                   for y in (yc, yp)]
            res["small"][f"{kind} {n_bits}"] = dict(
                far=float((np.abs(yc - yp) > 1e-5 * scale).mean()),
                rms_card=rms[0], rms_cpu=rms[1])
    pathlib.Path(out_path).write_text(json.dumps(res))
    dist.destroy_process_group()


def gloo_cuda_probe(rank, store_path, out_path):
    """Whether gloo's isend/irecv take CUDA tensors (a finding, not a path
    of the port: ``compressed_psum`` stages gloo payloads through host
    memory). Rank 0 sends a CUDA tensor to rank 1."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=2,
                            store=dist.FileStore(store_path, 2))
    t = torch.arange(1024, dtype=torch.float32, device="cuda") * (1 - rank)
    try:
        op = dist.isend(t, 1) if rank == 0 else dist.irecv(t, 0)
        op.wait(timeout=datetime.timedelta(seconds=30))
        torch.cuda.synchronize()
        ok = rank == 0 or bool((t.cpu() == torch.arange(1024.0)).all())
        what = "delivered" if ok else "wrong values"
    except RuntimeError as e:           # the finding: what gloo says
        what = "raised: " + str(e).splitlines()[0][:200]
    pathlib.Path(out_path).write_text(what)


def run_ranks(target, world, tmp, timeout):
    """Start ``world`` spawned processes of ``target(rank, store, out)``,
    wait for all, stop any left; returns the exit codes and the out
    paths."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    store = str(pathlib.Path(tmp) / f"{target.__name__}.store")
    outs = [str(pathlib.Path(tmp) / f"{target.__name__}.{r}.out")
            for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, store, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return [p.exitcode for p in procs], outs


def phase_ring(torch, card, kernels):
    """Phase (e); returns the launch counts of rank 0's 8-bit call.
    ``kernels``: phase (b)'s rows, whose LogFMT graph times give the
    kernels' share of a call."""
    import tempfile
    torch.cuda.empty_cache()               # the served paths' cached blocks
    N, D = RING_SHAPE
    log(f"[e] compressed_psum on {RING_WORLD} gloo ranks on one card "
        f"({card}), per rank ({N}, {D}) fp32 (a DeepSeek-V3 dense w1 "
        "gradient at published width)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        codes, outs = run_ranks(ring_rank, RING_WORLD, tmp, 600)
        if codes != [0] * RING_WORLD:
            raise AssertionError(f"ring ranks exited with {codes}")
        res = [json.loads(pathlib.Path(o).read_text()) for o in outs]
        log(f"[e] {RING_WORLD} ranks done in {time.perf_counter() - t0:.1f} "
            "s (spawn and CUDA start included)")
        probe_codes, probe_outs = run_ranks(gloo_cuda_probe, 2, tmp, 120)
        said = [pathlib.Path(o).read_text() if c == 0
                else f"killed by signal {-c}" if c is not None and c < 0
                else f"exit code {c}"
                for c, o in zip(probe_codes, probe_outs)]
        log(f"[e] gloo isend/irecv of CUDA tensors (torch "
            f"{torch.__version__}): sender {said[0]}; receiver {said[1]}")
    hops = 2 * (RING_WORLD - 1)
    rows = N // RING_WORLD
    for n_bits in RING_BITS:
        calls = [r["calls"][str(n_bits)] for r in res]
        for r, c in enumerate(calls):
            got = (c["launches"]["logfmt_encode"],
                   c["launches"]["logfmt_decode"])
            if got != (hops, hops):
                raise AssertionError(f"rank {r}, {n_bits} bits: launched "
                                     f"(encode, decode) {got}, want "
                                     f"({hops}, {hops})")
            if not (c["finite"] and c["shape"] == [N, D]
                    and c["dtype"] == "torch.float32"):
                raise AssertionError(f"rank {r}, {n_bits} bits: output "
                                     f"finite={c['finite']} {c['shape']} "
                                     f"{c['dtype']}")
        err = max(c["err"] for c in calls)
        if n_bits == 10 and not err <= 0.05:
            raise AssertionError(f"10-bit ring: error {err:.4g} of "
                                 "max|exact| > 0.05")
        code_bytes = 1 if n_bits <= 8 else 2
        hop_bytes = rows * D * code_bytes + 8 * rows * D // 128
        log(f"[e] {n_bits} bits: every rank launched logfmt_encode and "
            f"logfmt_decode {hops} times each; max error over members "
            f"{err:.4g} of max|exact|"
            f"{' (bound 0.05)' if n_bits == 10 else ' (not gated)'}; wire "
            f"per hop {hop_bytes / 1e6:.2f} MB, "
            f"{8 * hop_bytes / (rows * D)} bits per element as sent (codes "
            f"in {8 * code_bytes}-bit words, as the reference's ring sends "
            f"them; {n_bits + 0.5} if packed), against 32 for fp32 and 16 "
            "for bf16 (computed from the payload shapes)")
        log(f"[e] {n_bits} bits: wall ms per compressed_psum call, 4 gloo "
            "ranks on one card, wire staged through host memory (not a wire "
            f"figure): first call {[round(c['wall_ms'], 1) for c in calls]}"
            f", second {[round(c['warm_ms'], 1) for c in calls]}")
        i = RING_BITS.index(n_bits)
        per_call = hops * (kernels["logfmt_encode"][i]["ms"]
                           + kernels["logfmt_decode"][i]["ms"])
        log(f"[e] {n_bits} bits: the kernels' share of a second call, "
            f"{hops} x (encode + decode) at phase (b)'s graph times = "
            f"{per_call:.4f} ms: "
            f"{[round(100 * per_call / c['warm_ms'], 3) for c in calls]} %")
    log(f"[e] peak memory per rank: "
        f"{[round(r['peak_gb'], 2) for r in res]} GB")
    for key in res[0]["small"]:
        small = [r["small"][key] for r in res]
        far = max(m["far"] for m in small)
        rms = [(m["rms_card"], m["rms_cpu"]) for m in small]
        log(f"[e] card ring vs CPU ring, {RING_SMALL} {key} bits: elements "
            f"apart > 1e-5 of max|exact|: max over members {far:.3g}; RMS "
            "error of max|exact| card/CPU per member "
            f"{[(round(a, 6), round(b, 6)) for a, b in rms]}")
        if key.startswith("same-sign") and not far < 1e-3:
            raise AssertionError(f"card ring disagrees with the CPU ring "
                                 f"({key} bits): {far:.3g} of elements")
        if not all(abs(a - b) <= 0.1 * b for a, b in rms):
            raise AssertionError(f"card ring's RMS error differs from the "
                                 f"CPU ring's by over 10% ({key} bits)")
    return res[0]["calls"]["8"]["launches"]


# --- (f) ---------------------------------------------------------------------


# the host KV tier on qwen3-14b whole: the reference's bench sizing
# (tests/test_kv_tier.py: two slots, a device pool that holds two full
# requests, a host tier three times that), eight seeded prompts of 400-1500
# tokens, 32 new tokens each, a decode quantum of 2 ticks so residents
# rotate through the tier while others wait
TIER = dict(prefill_chunk=256, slots=2, quantum=2, n=8, lengths=(400, 1500),
            max_new=32)
# two DeepSeek-V3 replicas on phase (c)'s weights, each a chunked paged
# engine of three slots whose pool holds two of the six requests (so a
# third waits and the quantum rotates residents through the host tier);
# the faulted pass crashes replica 1 mid-decode and drops replica 0's
# tier link for pcie_ticks ticks from the tick after its first spill
GATEWAY = dict(replicas=2, slots=3, prefill_chunk=256, quantum=2,
               lengths=(300, 600), n=6, max_new=32, pcie_ticks=6)
# the gateway's allowance over its replicas' pools and graph pools: the
# engines' small device state (decode inputs, sampling state) and the
# cuBLAS workspaces of their graphs' streams — far under one copy of the
# 11.28 GB expert wall
GATEWAY_SLACK = 256 << 20


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def leaf_ptrs(tree):
    """Every cache leaf's data_ptr, by path."""
    if isinstance(tree, dict):
        return {k: leaf_ptrs(v) for k, v in tree.items()}
    return tree.data_ptr()


class TierMeter:
    """Times what the tier does on the card, around the engine's own calls:
    each staged copy (``serve/tier.staged_get`` / ``staged_put``: bytes,
    ms and GB/s; the card synchronised before and after, so a copy's time
    is its own) and each page-CRC pass (ms, by whether a spill or a fetch
    made it). Installed for one run, then removed."""

    def __init__(self, torch, eng):
        from repro_torch.core import paged as paged_mod
        from repro_torch.serve import tier as tier_mod
        self.torch, self.eng, self.dev = torch, eng, eng.device
        self.paged_mod, self.tier_mod = paged_mod, tier_mod
        self.copies = {"get": [], "put": []}
        self.crc = {"spill": [], "fetch": []}
        self.pinned = []
        self._where = None
        self._saved = (tier_mod.staged_get, tier_mod.staged_put,
                       paged_mod.payload_page_crcs)

    def _copy(self, kind, fn):
        torch, meter = self.torch, self

        def timed(tree, *a):
            _sync(torch, meter.dev)
            t0 = time.perf_counter()
            out = fn(tree, *a)
            _sync(torch, meter.dev)
            ms = 1e3 * (time.perf_counter() - t0)
            host = out if kind == "get" else tree
            meter.copies[kind].append((meter.paged_mod.payload_nbytes(host),
                                       ms))
            if kind == "get":
                meter.pinned += [t.is_pinned() for t in
                                 meter.paged_mod.payload_leaves(out)]
            return out
        return timed

    def _crcs(self, fn):
        meter = self

        def timed(payload, n):
            t0 = time.perf_counter()
            out = fn(payload, n)
            meter.crc.setdefault(meter._where, []).append(
                1e3 * (time.perf_counter() - t0))
            return out
        return timed

    def _tag(self, name, where):
        meter, fn = self, getattr(self.eng, name)

        def tagged(*a):
            meter._where = where
            try:
                return fn(*a)
            finally:
                meter._where = None
        setattr(self.eng, name, tagged)

    def __enter__(self):
        get, put, crcs = self._saved
        self.tier_mod.staged_get = self._copy("get", get)
        self.tier_mod.staged_put = self._copy("put", put)
        self.paged_mod.payload_page_crcs = self._crcs(crcs)
        self._tag("_begin_suspend", "spill")
        self._tag("_finish_fetch", "fetch")
        return self

    def __exit__(self, *exc):
        (self.tier_mod.staged_get, self.tier_mod.staged_put,
         self.paged_mod.payload_page_crcs) = self._saved
        for name in ("_begin_suspend", "_finish_fetch"):
            del self.eng.__dict__[name]
        return False

    def n_copies(self):
        return len(self.copies["get"]) + len(self.copies["put"])

    def summary(self, kind):
        """Each copy in order as MB / ms / GB/s."""
        rows = self.copies[kind]
        if not rows:
            return "none"
        each = ", ".join(f"{b / 1e6:.2f}/{m:.3f}/{b / m / 1e6:.2f}"
                         for b, m in rows)
        return (f"{len(rows)} copies, {sum(b for b, _ in rows) / 1e6:.2f} "
                f"MB in all; MB/ms/GB/s each: {each}")


def tier_prompts(np, vocab, spec, seed):
    rng = np.random.default_rng(seed)
    lo, hi = spec["lengths"]
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in rng.integers(lo, hi + 1, spec["n"])]


def phase_tier(torch, eng, spec=TIER, seed=5):
    """qwen3-14b whole with the host KV tier, on the weights of phase (c)'s
    engine ``eng``: a tiered chunked engine (``spec``) and an untiered one
    whose pool is as large, so nobody is preempted, serve the same eight
    requests; counters zeroed just before the tiered run and read just
    after. Gates (fatal): streams bitwise equal to the untiered engine's;
    suspensions > 0 and as many resumes; spilled pages == fetched pages >
    0; no CRC failure, no degradation; no page leaked and no tier entry
    left; both graphs captured once (``trace_counts``) and every cache leaf
    the tensor it was (``data_ptr``); every staged copy into pinned memory;
    flash_prefill and paged_gqa_decode launched. Printed: spill and fetch
    bytes, ms and GB/s of each staged copy, CRC ms per spill and per fetch,
    ms per tick with and without a transfer, and the host tier's bytes."""
    import numpy as np
    from repro_torch.kernels import registry
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.tier import TierConfig
    dev = eng.device
    for slot in eng.free_slots():
        eng.model.release_slot_pages(eng.cache, slot)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pps = eng.max_len // eng.page_size
    pool, host = 2 * pps, 6 * pps

    def engine(tiered):
        kw = (dict(host_tier_pages=host,
                   tier_config=TierConfig(quantum=spec["quantum"]))
              if tiered else {})
        return ServeEngine(eng.cfg, params=eng.params, slots=spec["slots"],
                           max_len=eng.max_len, device=dev, seed=0,
                           page_size=eng.page_size,
                           prefill_chunk=spec["prefill_chunk"],
                           pool_pages=pool, paged=True,
                           page_storage=eng.page_storage,
                           attn_impl=eng.attn_impl, **kw)

    prompts = tier_prompts(np, eng.cfg.vocab_size, spec, seed)
    log(f"[f] tier: {eng.cfg.name}, {eng.cfg.num_layers} layers, "
        f"ServeEngine(slots={spec['slots']}, max_len={eng.max_len}, page "
        f"{eng.page_size}, pool_pages={pool}, host_tier_pages={host}, "
        f"prefill_chunk={spec['prefill_chunk']}, TierConfig(quantum="
        f"{spec['quantum']})); {len(prompts)} prompts "
        f"{[len(p) for p in prompts]}, {spec['max_new']} new tokens each")

    flat = engine(False)
    base = [Request(i, p, max_new=spec["max_new"])
            for i, p in enumerate(prompts)]
    for r in base:
        flat.submit(r)
    t0 = time.perf_counter()
    flat_ticks = drive(flat)
    _sync(torch, dev)
    flat_wall = time.perf_counter() - t0
    if flat.stats["evictions"]:
        raise AssertionError("the untiered engine preempted")
    del flat

    ceng = engine(True)
    reqs = [Request(i, p, max_new=spec["max_new"])
            for i, p in enumerate(prompts)]
    before = leaf_ptrs(ceng.cache)
    registry.reset_launch_counts()
    ticks = {"with": [], "without": []}
    peak_host = 0
    t0 = time.perf_counter()
    with TierMeter(torch, ceng) as meter:
        for r in reqs:
            ceng.submit(r)
        n = 0
        while ceng.has_work():
            copies = meter.n_copies()
            _sync(torch, dev)
            t1 = time.perf_counter()
            ceng.step()
            _sync(torch, dev)
            ms = 1e3 * (time.perf_counter() - t1)
            ticks["with" if meter.n_copies() > copies else
                  "without"].append(ms)
            peak_host = max(peak_host, ceng.tier.host_bytes())
            n += 1
            if n > 600:
                raise AssertionError("the tiered engine did not finish in "
                                     "600 ticks")
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    ts = ceng.tier_stats()
    log(f"[f] tier: untiered run {flat_ticks} ticks {flat_wall:.3f} s; "
        f"tiered run {n} ticks {wall:.3f} s; tier_stats {ts}; stats "
        f"{ceng.stats}; trace_counts {ceng.trace_counts}; launches {counts}")
    return dict(base=base, reqs=reqs, eng=ceng, ts=ts, counts=counts,
                before=before, meter=meter, ticks=ticks, peak_host=peak_host,
                pool=pool)


def check_tier(torch, out):
    """Phase (f)'s tier gates and figures (see ``phase_tier``)."""
    ceng, ts, meter = out["eng"], out["ts"], out["meter"]
    for a, b in zip(out["base"], out["reqs"]):
        d = first_diff(a.out, b.out)
        if d is not None or not b.done:
            raise AssertionError(f"tiered request {b.rid}: done={b.done}, "
                                 f"first differs from the untiered stream "
                                 f"at token {d}")
    if not (ts["suspensions"] > 0 and ts["resumes"] == ts["suspensions"]):
        raise AssertionError(f"tier: {ts['suspensions']} suspensions, "
                             f"{ts['resumes']} resumes")
    if not ts["spilled_pages"] == ts["fetched_pages"] > 0:
        raise AssertionError(f"tier: {ts['spilled_pages']} pages spilled, "
                             f"{ts['fetched_pages']} fetched")
    if ts["crc_failures"] or ts["degraded"]:
        raise AssertionError(f"tier: {ts['crc_failures']} CRC failures, "
                             f"{ts['degraded']} degraded")
    if (ceng.free_pages() != out["pool"] or ceng.tier.entries()
            or ts["suspended"] or ts["transfers_inflight"]):
        raise AssertionError("tier: pages leaked or tier entries left")
    want_tc = {"decode": 1, "chunk": 1} if ceng.device.type == "cuda" \
        else {"decode": 0, "chunk": 0}
    if ceng.trace_counts != want_tc:
        raise AssertionError(f"tier: trace_counts {ceng.trace_counts}")
    if leaf_ptrs(ceng.cache) != out["before"]:
        raise AssertionError("tier: a cache leaf was rebound")
    if ceng.device.type == "cuda" and not all(meter.pinned):
        raise AssertionError("tier: a staged copy left pinned memory")
    for k in ("flash_prefill", "paged_gqa_decode"):
        if ceng.device.type == "cuda" and out["counts"][k] <= 0:
            raise AssertionError(f"tier: {k} never launched")
    log(f"[f] tier gates held: {len(out['reqs'])} streams bitwise equal to "
        f"the untiered engine's; {ts['suspensions']} suspensions, "
        f"{ts['resumes']} resumes, {ts['spilled_pages']} pages spilled and "
        f"fetched, 0 CRC failures, 0 degraded, no page or entry left, "
        f"trace_counts {ceng.trace_counts}, no cache leaf rebound")
    page = sum(t[:, 0].numel() * t.element_size()
               for seg in ceng.model.segments
               for t in ceng.cache[seg.name].values())
    log(f"[f] tier bytes: spill {ts['spill_bytes']} B (suspensions "
        f"{ts['spilled_pages']} pages, harvested prefix pages "
        f"{ts['prefix_spilled']}), fetch {ts['fetch_bytes']} B; {page} B a "
        f"page; {ts['spilled_pages'] * page / ts['suspensions'] / 1e6:.2f} "
        f"MB a suspension")
    log(f"[f] staged_get (device -> pinned host, then one wait): "
        f"{meter.summary('get')}")
    log(f"[f] staged_put (pinned host -> device, non-blocking, timed to its "
        f"end): {meter.summary('put')}")
    for kind in ("spill", "fetch"):
        ms = meter.crc[kind]
        if ms:
            log(f"[f] page CRCs per {kind}: {len(ms)} passes, "
                f"{min(ms):.2f}-{max(ms):.2f} ms (mean "
                f"{sum(ms) / len(ms):.2f})")
    for kind in ("with", "without"):
        ms = out["ticks"][kind]
        if ms:
            log(f"[f] ms per tick {kind} a staged copy: {len(ms)} ticks, "
                f"median {sorted(ms)[len(ms) // 2]:.2f}, "
                f"{min(ms):.2f}-{max(ms):.2f}")
    log(f"[f] host tier: peak {out['peak_host'] / 1e6:.2f} MB held in "
        f"pinned host memory (capacity {ceng.tier.capacity_pages} pages)")


def gateway_requests(np, vocab, spec, seed=6):
    return [(p, spec["max_new"]) for p in
            tier_prompts(np, vocab, spec, seed)]


def new_gateway(eng, spec, injector=None):
    from repro_torch.serve.gateway import Gateway
    from repro_torch.serve.tier import TierConfig
    _, hi = spec["lengths"]
    # two of the longest requests fit the pool, a third does not
    per = -(-(hi + spec["max_new"]) // eng.page_size)
    return Gateway(eng.cfg, params=eng.params, replicas=spec["replicas"],
                   slots=spec["slots"], max_len=eng.max_len, chunk=8,
                   paged=True, page_size=eng.page_size, pool_pages=2 * per,
                   page_storage=eng.page_storage,
                   prefill_chunk=spec["prefill_chunk"],
                   host_tier_pages=6 * per,
                   tier_config=TierConfig(quantum=spec["quantum"]),
                   injector=injector, attn_impl=eng.attn_impl,
                   device=eng.device)


def run_gateway(torch, gw, work, crash_at=None):
    """Submit ``work`` and tick ``gw`` to the end; returns the requests,
    each request's delivered stream at tick ``crash_at - 1``, and the tick
    of replica 0's first spill."""
    reqs = [gw.submit(p, max_new=m) for p, m in work]
    e0 = gw.registry.replicas[0].engine
    pre = spill_at = None
    for _ in range(400):
        if not gw.outstanding():
            break
        gw.tick()
        if crash_at is not None and gw.clock == crash_at - 1:
            pre = [list(r.delivered) for r in reqs]
        if spill_at is None and e0.tstats["suspensions"]:
            spill_at = gw.clock
    if gw.outstanding():
        raise AssertionError("the gateway did not finish in 400 ticks")
    _sync(torch, e0.device)
    return reqs, pre, spill_at


def engine_bytes(tree):
    if isinstance(tree, dict):
        return sum(engine_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def phase_gateway(torch, eng, spec=GATEWAY):
    """Two DeepSeek-V3 gateway replicas on the weights of phase (c)'s
    engine ``eng``, each a chunked paged engine with a host tier; a
    fault-free pass, then a pass that crashes replica 1 mid-decode and
    drops replica 0's tier link (``crash:1``, ``pcie_drop:0``). Gates
    (fatal): every request finishes with its token count; a retried
    request's delivered prefix is never regenerated; replica 1 is DEAD
    and its residents were retried on replica 0; the replicas share the
    weights (the expert codes' data_ptr is phase (c)'s), and the gateway's
    growth in allocated memory is under its replicas' pools plus their
    graph pools (plus ``GATEWAY_SLACK``); fp8_gemm, moe_gemm and
    paged_mla_decode launched. Printed: where each retried stream first
    parts from the fault-free one, the tier counters of each replica."""
    import numpy as np
    from repro_torch.kernels import registry
    from repro_torch.serve.fault import ServeFaultInjector
    from repro_torch.serve.gateway import DEAD
    dev = eng.device
    cuda = dev.type == "cuda"
    for slot in eng.free_slots():
        eng.model.release_slot_pages(eng.cache, slot)
    if cuda:
        torch.cuda.empty_cache()
    work = gateway_requests(np, eng.cfg.vocab_size, spec)
    log(f"[f] gateway: {eng.cfg.name}, {eng.cfg.num_layers} layers, "
        f"{spec['replicas']} replicas x ServeEngine(slots={spec['slots']}, "
        f"max_len={eng.max_len}, prefill_chunk={spec['prefill_chunk']}, "
        f"host tier, quantum {spec['quantum']}); {len(work)} requests, "
        f"prompts {[len(p) for p, _ in work]}, {spec['max_new']} new tokens")

    a0 = torch.cuda.memory_allocated() if cuda else 0
    registry.reset_launch_counts()
    gw = new_gateway(eng, spec)
    a1 = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    clean, _, spill_at = run_gateway(torch, gw, work)
    wall = time.perf_counter() - t0
    a2 = torch.cuda.memory_allocated() if cuda else 0
    counts = registry.launch_counts()
    reps = list(gw.registry.replicas.values())
    pools = sum(engine_bytes(r.engine.cache) for r in reps)
    graphs = sum(r.engine._decode.pool_bytes + r.engine._prefill.pool_bytes
                 for r in reps)
    log(f"[f] gateway fault-free pass: {gw.clock} ticks, {wall:.3f} s; "
        f"stats {gw.stats}; per replica tier_stats "
        f"{[r.engine.tier_stats() for r in reps]}; trace_counts "
        f"{[r.engine.trace_counts for r in reps]}; launches {counts}")
    log(f"[f] gateway memory: allocated +{(a1 - a0) / 1e6:.1f} MB at "
        f"construction, +{(a2 - a0) / 1e6:.1f} MB after the pass; the two "
        f"pools {pools / 1e6:.1f} MB, their graph pools "
        f"{graphs / 1e6:.1f} MB")
    def codes(params):                   # E4M3 codes, or the plain stack
        w1 = params["blocks"]["moe"]["w1"]
        return getattr(w1, "wq", w1).data_ptr()
    ptr = {codes(r.engine.params) for r in reps} | {codes(eng.params)}
    if len(ptr) != 1:
        raise AssertionError("gateway: the replicas hold their own copies "
                             "of the expert codes")
    if cuda and (a1 - a0 > pools + GATEWAY_SLACK
                 or a2 - a0 > pools + graphs + GATEWAY_SLACK):
        raise AssertionError("gateway: allocated memory grew past the "
                             "replicas' pools and graph pools")
    for k in ("fp8_gemm", "moe_gemm", "paged_mla_decode"):
        if cuda and counts[k] <= 0:
            raise AssertionError(f"gateway: {k} never launched")
    if not any(r.engine.tstats["suspensions"] for r in reps):
        raise AssertionError("gateway: no replica used its host tier")
    # the faulted pass: replica 1 crashes at the first tick where it has a
    # request mid-decode; replica 0's link drops from the tick after its
    # first spill
    crash_at = next(gr.first_token_tick + 1 for gr in clean
                    if gr.replica == 1 and gr.first_token_tick is not None
                    and gr.finished_tick > gr.first_token_tick + 1)
    if spill_at is None:
        raise AssertionError("gateway: replica 0 never spilled")
    del gw, reps
    if cuda:
        torch.cuda.empty_cache()
    sched = {crash_at: "crash:1", spill_at + 1: "pcie_drop:0"}
    inj = ServeFaultInjector(sched, pcie_ticks=spec["pcie_ticks"])
    gw = new_gateway(eng, spec, inj)
    t0 = time.perf_counter()
    faulted, pre, _ = run_gateway(torch, gw, work, crash_at)
    wall = time.perf_counter() - t0
    reps = list(gw.registry.replicas.values())
    log(f"[f] gateway faulted pass ({sched}, pcie_ticks "
        f"{spec['pcie_ticks']}): {gw.clock} ticks, {wall:.3f} s; stats "
        f"{gw.stats}; health {gw.registry.states()}; events "
        f"{inj.events}; replica 0 tier_stats {reps[0].engine.tier_stats()}")
    for gr, (_, m) in zip(faulted, work):
        if gr.state != "done" or len(gr.delivered) != m:
            raise AssertionError(f"gateway request {gr.gid}: {gr.state}, "
                                 f"{len(gr.delivered)} tokens (want {m})")
    for before, gr in zip(pre, faulted):
        if gr.delivered[:len(before)] != before:
            raise AssertionError(f"gateway request {gr.gid}: a delivered "
                                 "token was regenerated")
    retried = [gr for gr in faulted if gr.retries]
    if (gw.registry.replicas[1].state != DEAD or not retried
            or gw.stats["replica_deaths"] != 1
            or any(gr.replica != 0 for gr in retried)):
        raise AssertionError("gateway: replica 1 is not dead, or its "
                             "residents were not retried on replica 0")
    diffs = [first_diff(a.delivered, b.delivered)
             for a, b in zip(clean, faulted)]
    log(f"[f] gateway gates held: every request done with its tokens, "
        f"{len(retried)} retried on replica 0 with the delivered prefix "
        f"kept, replica 1 DEAD, one copy of the weights; first token where "
        f"each stream parts from the fault-free pass (None = equal; "
        f"printed, not gated: a continuation's first token comes from a "
        f"prefill chunk, and the MoE's capacity contest depends on which "
        f"requests share a step): {diffs}")
    del gw, reps
    if cuda:
        torch.cuda.empty_cache()


def phase_disagg(torch, eng):
    """``Disaggregator(paged=True)`` on DeepSeek-V3, phase (c)'s weights
    and requests: prefill, the handoff of each request's quantized pages,
    admission and decode. Gates (fatal): streams bitwise equal to the same
    requests through the engine's own admission, ``handoff_bytes`` equal
    to the sum of ``cache_nbytes`` over the payloads, the path's kernels
    launched. Printed: bytes per request."""
    import numpy as np
    from repro_torch.kernels import registry
    from repro_torch.serve.disagg import Disaggregator, cache_nbytes
    from repro_torch.serve.engine import Request, ServeEngine
    dev = eng.device
    for slot in eng.free_slots():
        eng.model.release_slot_pages(eng.cache, slot)
    rng = np.random.default_rng(0)
    lengths = DSV3_PROMPTS["lengths"]
    prompts = [rng.integers(0, eng.cfg.vocab_size, L).astype(np.int32)
               for L in lengths]
    registry.reset_launch_counts()
    dis = Disaggregator(eng.cfg, params=eng.params, decode_slots=4,
                        max_len=eng.max_len, paged=True,
                        page_size=eng.page_size,
                        page_storage=eng.page_storage,
                        attn_impl=eng.attn_impl, device=dev)
    reqs = [Request(i, p, max_new=32) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    wire = []
    for r in reqs:
        dis.submit(r)
        wire.append(cache_nbytes(dis.queue[-1].cache1))
    dis.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    own = ServeEngine(eng.cfg, params=eng.params, slots=4,
                      max_len=eng.max_len, paged=True,
                      page_size=eng.page_size, page_storage=eng.page_storage,
                      attn_impl=eng.attn_impl, device=dev, seed=0)
    twins = [Request(r.rid, r.prompt, max_new=32) for r in reqs]
    for r in twins:
        own.submit(r)
    own.run_until_done()
    log(f"[f] disagg: Disaggregator(paged=True, fp8 pages, decode_slots=4) "
        f"{len(reqs)} requests, prompts {list(lengths)}, {wall:.3f} s; "
        f"handoff bytes per request {wire} ({[round(w / len(p), 1) for w, p in zip(wire, prompts)]} B a prompt "
        f"token, the payload padded to its bucket), handoff_bytes "
        f"{dis.handoff_bytes}; launches {counts}")
    diffs = [first_diff(a.out, b.out) for a, b in zip(reqs, twins)]
    if any(d is not None for d in diffs) or not all(r.done for r in reqs):
        raise AssertionError(f"disagg streams differ from the engine's own "
                             f"admission at tokens {diffs}")
    if dis.handoff_bytes != sum(wire):
        raise AssertionError(f"disagg: handoff_bytes {dis.handoff_bytes} "
                             f"!= {sum(wire)}")
    for k in ("fp8_gemm", "moe_gemm", "paged_mla_decode"):
        if dev.type == "cuda" and counts[k] <= 0:
            raise AssertionError(f"disagg: {k} never launched")
    log("[f] disagg gates held: streams bitwise equal to the engine's own "
        "admission, handoff_bytes the sum of cache_nbytes over the payloads")
    del dis, own


# --- main ----------------------------------------------------------------------


# --- (g) ---------------------------------------------------------------------

# the card's training configuration: DeepSeek-V3's dense prefix at published
# widths (its three dense layers and its MTP module; the MoE layers wait for
# expert parallelism, ROADMAP.md A.8), bf16, FP8 linears through fp8_gemm
TRAIN = dict(model="deepseek-v3-671b",
             overrides=dict(family="dense", moe=None, num_layers=3,
                            fp8_impl="pallas"),
             seq_len=512, global_batch=2, steps=6, peak_lr=3e-4, warmup=2,
             tokens=1024)
# the fp8 path's input-width threshold (models/layers.linear)
FP8_MIN_K = 256


def fp8_linears(model):
    """FP8 linears of one forward pass, from the parameter specs: every
    stacked 2-D weight under attn/mlp/mtp whose input width reaches the FP8
    path, once per layer."""
    from repro_torch.train.optimizer import tree_items
    return sum(s.shape[0] for path, s in tree_items(model.specs())
               if len(s.shape) == 3 and s.shape[1] >= FP8_MIN_K
               and any(k in path for k in ("attn", "mlp", "mtp")))


# uses of each (K, N) of ops.SERVED_KN in one forward pass of the training
# config: 3 dense layers and the MTP block each hold one of each MLA and
# FFN weight (w_uk and w_uv, w_gate and w_up share a shape); w_proj is the
# MTP module's own
TRAIN_USES = {"w_proj": 1, "w_uk/w_uv": 8, "w_gate/w_up": 8}


def bench_fp8_train(torch, dev, gen):
    """The three fp8_gemm products of every FP8 weight of the card's
    training config, at T = 1024 tokens, in phase (b)'s style: the forward
    (T, K=d_in) x (d_in, N=d_out); the backward's dx = Q_tile(g) @
    Q_block(wᵀ), (T, K=d_out) x (d_out, N=d_in), and dw = Q_tile(x2ᵀ) @
    Q_block(g2), (d_in, K=T) x (T, N=d_out), x2ᵀ a transposed view.
    Operands are made as the FP8 linear makes them
    (``fp8_gemm.operands``); each product is timed in a CUDA graph and held
    within 2e-5 of the plain version's max, and the eager call with its
    plain quantization of both operands is timed beside it. Ends with
    the step's sums by pass (each shape times its uses, ``TRAIN_USES``)."""
    from repro_torch.core import fp8
    from repro_torch.kernels import registry
    from repro_torch.kernels.fp8_gemm import ops
    tol = 2e-5
    T = TRAIN["tokens"]
    sms = registry.sm_count(dev)
    rows = []
    for what, (d_in, d_out) in ops.SERVED_KN.items():
        w = (torch.randn(d_in, d_out, generator=gen, device=dev) * 0.02
             ).bfloat16()
        g2 = torch.randn(T, d_out, generator=gen, device=dev) * 1e-3
        x2 = torch.randn(T, d_in, generator=gen, device=dev).bfloat16()
        for kind, (a, b) in (("fwd", (x2, w)), ("dx", (g2, w.t())),
                             ("dw", (x2.float().t(), g2))):
            xq, xs, wq, ws = ops.operands(a, b)
            M, K = xq.shape
            N = wq.shape[1]
            y = ops.fp8_gemm(xq, xs, wq, ws)
            ref = ops.fp8_gemm.run_plain(xq, xs, wq, ws)
            err, rel = max_err(torch, y, ref)
            check(f"fp8_gemm backward {kind} {what}", rel, tol)
            plan = ops.launch_plan(M, N, K, sms)
            row = dict(shape=f"{kind} of {what}: M={M} K={K} N={N}",
                       max_abs_err=err, rel_err=rel, tol=tol, plan=plan,
                       weight=what, kind=kind)
            row["ms"] = graph_ms(torch, [
                lambda: ops.fp8_gemm(xq, xs, wq, ws)] * 10)
            xb = fp8.dequant_tilewise(xq, xs).bfloat16()
            wb = fp8.dequant_blockwise(wq, ws).bfloat16()
            row["bf16_mm_ms"] = graph_ms(torch, [
                lambda: torch.matmul(xb, wb)] * 10)
            row["plain_ms"] = cuda_ms(torch, lambda: ops.fp8_gemm.run_plain(
                xq, xs, wq, ws), 3)
            # the whole product as the backward calls it (plain tensor
            # quantization of both operands, then the kernel), eagerly
            row["call_ms"] = cuda_ms(torch, lambda: ops.fp8_matmul(a, b), 5)
            nbytes = M * K + M * (K // 128) * 4 + K * N + ws.numel() * 4 \
                + M * N * 4
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, 2 * M * N * K, "fp8")
            row["bound16_ms"], _ = bound_ms(nbytes, 2 * M * N * K, "bf16")
            row["library_ms"] = scaled_mm_ms(torch, xq, xs, wq, ws, ref)
            split = (f"decode: {plan.grid} CTAs x {plan.per} units"
                     if plan.mode == "decode" else
                     f"prefill: {plan.grid} persistent CTAs over "
                     f"{-(-M // 128) * -(-N // 128)} tiles, K split "
                     f"{plan.maxc}")
            lib = ("null" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f}")
            row["uses"] = TRAIN_USES.get(what, 4)
            log(f"[g.1] fp8_gemm {row['shape']}: max err {rel:.3g} of "
                f"max|plain| (tol {tol:g}); {split}; graph "
                f"{row['ms']:.4f} ms; bound {row['bound_ms']:.4f} ms at the "
                f"fp8 rate ({row['bound_by']}), {row['bound16_ms']:.4f} at "
                f"the fp16 rate; plain {row['plain_ms']:.4f} ms; "
                f"scaled_mm {lib} ms; bf16 torch.matmul on the dequantized "
                f"operands {row['bf16_mm_ms']:.4f} ms (kernel / matmul "
                f"{row['ms'] / row['bf16_mm_ms']:.3f}); the eager call with "
                f"its quantization {row['call_ms']:.4f} ms")
            rows.append(row)
            del xq, xs, wq, ws, y, ref, xb, wb
        del w, g2, x2
        torch.cuda.empty_cache()
    for kind in ("fwd", "dx", "dw"):
        rs = [r for r in rows if r["kind"] == kind]
        k = sum(r["uses"] * r["ms"] for r in rs)
        c = sum(r["uses"] * r["call_ms"] for r in rs)
        b = sum(r["uses"] * r["bound16_ms"] for r in rs)
        log(f"[g.1] a step's {kind} products ({sum(r['uses'] for r in rs)} "
            f"launches): kernels {k:.2f} ms in graphs (fp16-rate bound "
            f"{b:.2f} ms), the eager calls with their plain quantization "
            f"{c:.2f} ms")
    return rows


def leaf_sums(torch, tree):
    """One int64 sum of each leaf's bits (no copy of the leaf): a leaf
    whose sum moved has changed."""
    from repro_torch.train.optimizer import tree_items
    out = {}
    for path, t in tree_items(tree):
        ints = {4: torch.int32, 2: torch.int16}[t.element_size()]
        out[path] = int(t.view(ints).sum(dtype=torch.int64))
    return out


def train_step_profile(torch, tr):
    """One more step of ``tr`` split in three profiled windows: the
    forward (``Model.loss``), the backward (``torch.autograd.grad``) and
    the optimizer with the router-bias update (``optimizer.update``), the
    same calls in the order ``trainer.make_train_step`` makes them."""
    from repro_torch.train import optimizer as optim
    from repro_torch.train import schedule as sched
    batch = {k: torch.from_numpy(v).to(tr.device)
             for k, v in tr.data.batch_at(tr.step).items()}
    items = optim.tree_items(tr.params)
    leaves = [t for _, t in items]
    st = {}
    for t in leaves:
        t.requires_grad_(True)

    def fwd():
        st["loss"], _ = tr.model.loss(tr.params, batch)

    def bwd():
        st["grads"] = torch.autograd.grad(st["loss"], leaves,
                                          allow_unused=True)

    fwd_ms = profile_device(torch, "[g.2] forward (Model.loss)", fwd, 1,
                            "step")
    bwd_ms = profile_device(torch, "[g.2] backward (autograd.grad)", bwd, 1,
                            "step")
    for t in leaves:
        t.requires_grad_(False)
    gtree = {}
    for (path, _), g in zip(items, st.pop("grads")):
        node = gtree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    tc = tr.tc
    lr = sched.warmup_cosine(tr.step, peak_lr=tc.peak_lr, warmup=tc.warmup,
                             total=tc.total_steps)

    def opt():
        optim.update(gtree, tr.opt_state, tr.params, lr=lr,
                     weight_decay=tc.weight_decay, clip_norm=tc.clip_norm)

    opt_ms = profile_device(torch, "[g.2] optimizer (AdamW, in place)", opt,
                            1, "step")
    tr.step += 1
    return fwd_ms, bwd_ms, opt_ms


def phase_train(torch):
    """(g.2): the card's training config trained for ``TRAIN["steps"]``
    steps through ``Trainer``; returns the backward launches of the run."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import registry
    from repro_torch.train.optimizer import tree_items
    from repro_torch.train.trainer import Trainer, TrainConfig

    cfg = get_config(TRAIN["model"], **TRAIN["overrides"])
    tc = TrainConfig(peak_lr=TRAIN["peak_lr"], warmup=TRAIN["warmup"],
                     total_steps=TRAIN["steps"])
    data = SyntheticCorpus(cfg.vocab_size, TRAIN["seq_len"],
                           TRAIN["global_batch"], seed=tc.seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, data=data, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_items(tr.params))
    state_gb = 12 * n / 1e9
    log(f"[g.2] {cfg.name} dense prefix ({cfg.num_layers} layers + MTP, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"{n} parameters drawn on the card in {time.perf_counter() - t0:.2f}"
        f" s; state {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated"
        f" (10 B a parameter: {10 * n / 1e9:.2f} GB; with bf16 grads "
        f"{state_gb:.2f} GB)")
    dts = {(k, t.dtype) for k, tree in (("param", tr.params),
                                         ("master", tr.opt_state.master),
                                         ("m", tr.opt_state.m),
                                         ("v", tr.opt_state.v))
           for _, t in tree_items(tree)}
    want = {("param", torch.bfloat16), ("master", torch.float32),
            ("m", torch.bfloat16), ("v", torch.bfloat16)}
    if dts != want:
        raise AssertionError(f"state dtypes {sorted(map(str, dts))}, want "
                             f"{sorted(map(str, want))}")
    per_pass = fp8_linears(tr.model)
    batch0 = {k: torch.from_numpy(v).cuda()
              for k, v in data.batch_at(0).items()}
    registry.reset_launch_counts()
    with torch.no_grad():
        tr.model.loss(tr.params, batch0)
    fwd = registry.launch_counts()["fp8_gemm"]
    log(f"[g.2] fp8_gemm launches of one forward pass: {fwd} (the FP8 "
        f"linears by the specs: {per_pass})")
    if fwd != per_pass:
        raise AssertionError(f"forward launched fp8_gemm {fwd} times, the "
                             f"specs hold {per_pass} FP8 linears")
    del batch0
    before = leaf_sums(torch, tr.opt_state.master)
    step_ms, counts = [], []
    for i in range(TRAIN["steps"]):
        registry.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        c = registry.launch_counts()
        counts.append(c)
        if c["fp8_gemm"] != 3 * fwd or any(
                v for k, v in c.items() if k != "fp8_gemm"):
            raise AssertionError(f"step {i}: launches {c}, want fp8_gemm "
                                 f"{3 * fwd} (3 per FP8 linear) only")
        after = leaf_sums(torch, tr.opt_state.master)
        moved = [p for p in after if after[p] != before[p]]
        if i == 0 and moved:
            raise AssertionError(f"step 0 runs at lr 0 but moved {moved}")
        if i == 1 and len(moved) != len(after):
            raise AssertionError("after step 1 the master copies of "
                                 f"{sorted(set(after) - set(moved))} have "
                                 "not changed")
        before = after
    h = tr.history
    losses = [x["loss"] for x in h]
    if len(h) != TRAIN["steps"] or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if peak >= total:
        raise AssertionError(f"peak memory {peak} >= the card's {total}")
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    steady = step_ms[2:]
    log(f"[g.2] losses {[round(v, 4) for v in losses]}; ce "
        f"{[round(x['ce'], 4) for x in h]}; mtp_loss "
        f"{[round(x['mtp_loss'], 4) for x in h]}; grad_norm "
        f"{[round(x['grad_norm'], 3) for x in h]}; lr "
        f"{[x['lr'] for x in h]}")
    log(f"[g.2] fp8_gemm launches a step {counts[-1]['fp8_gemm']} = 3 x "
        f"{fwd} (forward, dx, dw); every master leaf unchanged after step 0 "
        "(lr 0) and changed after step 1")
    log(f"[g.2] ms a step {[round(v, 2) for v in step_ms]} (steps 1-6; "
        f"steps 3-6 mean {np.mean(steady):.2f}, min {min(steady):.2f}); "
        f"{tokens} tokens a step: {1e3 * tokens / np.mean(steady):.1f} "
        f"tokens/s; peak memory {peak / 1e9:.2f} GB of the card's "
        f"{total / 1e9:.2f} (state reckoned at {state_gb:.2f} GB, so "
        f"{(peak / 1e9 - state_gb):.2f} GB of activations and temporaries)")
    fwd_ms, bwd_ms, opt_ms = train_step_profile(torch, tr)
    if None not in (fwd_ms, bwd_ms, opt_ms):
        log(f"[g.2] profiled step (step 7): device forward {fwd_ms:.2f} ms,"
            f" backward {bwd_ms:.2f}, optimizer {opt_ms:.2f}; "
            f"{fwd_ms + bwd_ms + opt_ms:.2f} ms of device time")
    back = sum(c["fp8_gemm"] - fwd for c in counts)
    del tr
    gc_cuda(torch)
    return back, step_ms, losses


# (g.2)'s two more curves, the same six steps from the same seed: the FP8
# linears on the plain path (``fp8_impl="ref"``: inline quantization and
# fp32 products, no fp8_gemm) and at a tenth of the peak lr; a fault of
# fp8_gemm would part its curve from the plain one's
TRAIN_CURVES = (("fp8_impl=ref", dict(fp8_impl="ref"), 1.0),
                ("peak lr / 10", {}, 0.1))


def phase_train_curves(torch, losses):
    """(g.2): ``TRAIN_CURVES`` beside the fp8_gemm run's ``losses``; each
    run on one device, freed after. Returns {label: losses}."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.train.trainer import Trainer, TrainConfig
    curves = {"fp8_gemm": losses}
    for label, over, lr_scale in TRAIN_CURVES:
        cfg = get_config(TRAIN["model"], **dict(TRAIN["overrides"], **over))
        tc = TrainConfig(peak_lr=TRAIN["peak_lr"] * lr_scale,
                         warmup=TRAIN["warmup"], total_steps=TRAIN["steps"])
        data = SyntheticCorpus(cfg.vocab_size, TRAIN["seq_len"],
                               TRAIN["global_batch"], seed=tc.seed)
        t0 = time.perf_counter()
        tr = Trainer(cfg, tc, data=data, device="cuda")
        out = tr.run(TRAIN["steps"])
        curves[label] = [x["loss"] for x in out["history"]]
        if not all(math.isfinite(v) for v in curves[label]):
            raise AssertionError(f"(g.2) {label}: losses {curves[label]}")
        log(f"[g.2] {label}: losses "
            f"{[round(v, 4) for v in curves[label]]}, grad_norm "
            f"{[round(x['grad_norm'], 3) for x in out['history']]} "
            f"({time.perf_counter() - t0:.1f} s)")
        del tr
        gc_cuda(torch)
    ref = curves["fp8_impl=ref"]
    log(f"[g.2] the fp8_gemm curve against the plain path's: max abs diff "
        f"{max(abs(a - b) for a, b in zip(losses, ref)):.4g}, max rel "
        f"{max(abs(a - b) / abs(b) for a, b in zip(losses, ref)):.4g}")
    return curves


def gc_cuda(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_smoke_config(which):
    """(g.3)'s small configs: (i) the dense prefix of (g.2) at smoke width,
    bf16, FP8 through fp8_gemm (smoke d_ff 256 and the MTP projection's
    2 x 128 reach the FP8 path); (ii) smoke DeepSeek-V3 with its MoE
    layers, fp32, FP8 inline (``fp8_impl="ref"``): routing, dispatch and
    the bias update on CUDA, plain."""
    import dataclasses
    from repro_torch.configs.base import get_config, smoke_config
    if which == "dense":
        return dataclasses.replace(
            smoke_config(get_config(TRAIN["model"], **TRAIN["overrides"])),
            dtype="bfloat16", param_dtype="bfloat16")
    return smoke_config(get_config(TRAIN["model"]))


# (g.3) tolerances, card (kernels, CUDA plain ops) against the CPU (plain
# versions): the loss of each step within LOSS_TOL relative; each master
# leaf after the steps within ADAM_SLACK x (the sum of the steps' lr) of
# the CPU's, element by element: Adam moves an element by at most about
# lr a step whatever its gradient (|m̂/√v̂| <= 1.0004 over these steps), so
# an element whose gradient is near zero may step the other way on the
# other device; and the direction of each leaf's whole update (master
# after - master before) within cosine UPDATE_COS of the CPU's (a wrong
# or transposed gradient would point elsewhere). Seen: least cosines
# 0.985 (bf16, the embedding, whose gradient accumulates by atomics on
# the card) and 0.996 (fp32).
LOSS_TOL = 2e-2
ADAM_SLACK = 2.1
UPDATE_COS = 0.9


def compare_training(torch, label, card, cpu):
    """Gate one card run against its CPU twin (``train_on`` results)."""
    from repro_torch.train import optimizer as optim
    hc, m0, m1c, n_fp8 = card
    hp, _, m1p, _ = cpu
    lerr = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(hc, hp))
    slack = ADAM_SLACK * sum(x["lr"] for x in hp)
    cos, worst, dmax = 1.0, None, 0.0
    for (path, a1), (_, b1), (_, a0) in zip(
            optim.tree_items(m1c), optim.tree_items(m1p),
            optim.tree_items(m0)):
        dmax = max(dmax, float((a1 - b1).abs().max()))
        da, db = (a1 - a0).flatten(), (b1 - a0).flatten()
        c = float(torch.nn.functional.cosine_similarity(
            da.double(), db.double(), dim=0))
        if c < cos:
            cos, worst = c, path
    log(f"[g.3] {label}: losses card {[round(x['loss'], 5) for x in hc]}, "
        f"CPU {[round(x['loss'], 5) for x in hp]} (max rel err {lerr:.3g},"
        f" tol {LOSS_TOL:g}); master leaves card vs CPU: max abs diff "
        f"{dmax:.3g} (<= {slack:.3g}, {ADAM_SLACK} x the steps' lr), "
        f"updates' cosine least {cos:.6f} at {'/'.join(worst)} (>= "
        f"{UPDATE_COS}); fp8_gemm launches {n_fp8}")
    if not (lerr <= LOSS_TOL and dmax <= slack and cos >= UPDATE_COS):
        raise AssertionError(f"{label}: the card's training disagrees with "
                             "the CPU's")


def train_on(torch, cfg, params, dev, steps=3, **trainer_kw):
    """``steps`` Trainer steps of ``cfg`` on ``dev`` from ``params`` (CPU
    tensors, copied); returns (history, master before, master after, fp8
    launches)."""
    from repro_torch.kernels import registry
    from repro_torch.train import optimizer as optim
    from repro_torch.train.trainer import Trainer, TrainConfig
    tc = TrainConfig(peak_lr=1e-3, warmup=1, total_steps=steps)
    tr = Trainer(cfg, tc, global_batch=2, seq_len=32, device=dev,
                 **trainer_kw)
    tr.params = optim.tree_map(lambda t: t.to(dev, copy=True), params)
    tr.opt_state = optim.init(tr.params)
    m0 = optim.tree_map(lambda t: t.float().cpu().clone(),
                        tr.opt_state.master)
    registry.reset_launch_counts()
    out = tr.run(steps)
    fp8_n = registry.launch_counts()["fp8_gemm"]
    m1 = optim.tree_map(lambda t: t.float().cpu(), tr.opt_state.master)
    return out["history"], m0, m1, fp8_n


def phase_train_reference(torch):
    """(g.3): the card against the CPU on small inputs, and the trainer's
    fault path on the card."""
    import tempfile
    from repro_torch.kernels.fp8_gemm import ops as fp8_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.models.api import Model
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.trainer import Trainer, TrainConfig

    for label, which, want_fp8 in (("(i) dense prefix, bf16, fp8_gemm",
                                    "dense", True),
                                   ("(ii) MoE, fp32, FP8 inline", "moe",
                                    False)):
        cfg = train_smoke_config(which)
        params = Model(cfg, device="cpu").init(seed=1)
        runs = {dev: train_on(torch, cfg, params, dev)
                for dev in ("cuda", "cpu")}
        n_fp8 = runs["cuda"][3]
        per_step = 3 * fp8_linears(Model(cfg, device="meta"))
        if n_fp8 != (3 * per_step if want_fp8 else 0):
            raise AssertionError(f"{label}: fp8_gemm launched {n_fp8} times "
                                 f"in 3 steps, want "
                                 f"{3 * per_step if want_fp8 else 0}")
        compare_training(torch, label, runs["cuda"], runs["cpu"])

    cfg = train_smoke_config("dense")
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=30, ckpt_dir=d,
                         ckpt_every=4, sdc_check_every=9)
        tr = Trainer(cfg, tc, injector=FailureInjector({9: "node",
                                                        18: "sdc"}),
                     global_batch=2, seq_len=16, device="cuda")
        out = tr.run(22)
    log(f"[g.3] (iii) Trainer with checkpoints and FailureInjector({{9: "
        f"node, 18: sdc}}) on the card: final_step {out['final_step']}, "
        f"restarts {out['restarts']}, sdc_alarms {out['sdc_alarms']}, "
        f"{len(out['history'])} steps run, last loss "
        f"{out['history'][-1]['loss']:.4f}")
    if (out["final_step"], out["restarts"], out["sdc_alarms"]) != (22, 1,
                                                                  [18]):
        raise AssertionError("the trainer's fault path on the card")
    del tr

    dev = torch.device("cuda")
    x = torch.randn(4, 8, 256, device=dev, requires_grad=True)
    w = torch.randn(4, 256, 128, device=dev).bfloat16()
    for name, call in (("moe_gemm", lambda: moe_ops.grouped_matmul(
            x.bfloat16(), w)),
                       ("fp8_gemm", lambda: fp8_ops.fp8_matmul(x[0], w[0]))):
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            log(f"[g.3] {name} with a grad-requiring input raises: "
                f"{str(e)[:150]}")
        else:
            raise AssertionError(f"{name} launched on a grad-requiring "
                                 "input: its gradients would be zero")

# phase (h): the mesh-sharded engine, 4 gloo ranks sharing the card, mesh
# (1, 4); DeepSeek-V3 paged fp8 (phase (c)'s path, weights and prompts) at
# the fp32 and the FP8 wire, then qwen3-14b whole with its MoE-free layers
MESH = (1, 4)
MESH_WORLD = 4
MESH_RUNS = (("deepseek-v3-671b", "fp32"), ("deepseek-v3-671b", "fp8"),
             ("qwen3-14b", None))
# a decode step's launches per rank: phase (c)'s per step (+ moe_gemm's 3
# per MoE layer); a prefill's
MESH_STEP = {"deepseek-v3-671b": {"fp8_gemm": 29, "moe_gemm": 3,
                                  "paged_mla_decode": 4},
             "qwen3-14b": {"paged_gqa_decode": 40}}
MESH_PREFILL = {"qwen3-14b": {"flash_prefill": 40}}
# each meshed run's requests: phase (c)'s first prompts and new tokens a
# request (phase (c) served six of 32). qwen3-14b's eager meshed prefill
# takes ~6.6 ms a token and its decode ~1.35 s a step, so its run serves
# the first four prompts (16-900 tokens) 16 tokens each: every request
# decodes two chunks, so the served run has decode-only ticks for the
# per-step launch gate. The logit gates read the served first tokens,
# the same at any budget, over the run's prompts
MESH_PROMPTS = {"deepseek-v3-671b": 6, "qwen3-14b": 4}
MESH_NEW = {"deepseek-v3-671b": 32, "qwen3-14b": 16}
# timed runs of the longest prompt's meshed prefill (printed, not gated)
MESH_PREFILL_RUNS = 1
# faults planted on the meshed engine after its run (``plant_fault``):
# the logit gate must reject each
MESH_FAULTS = {"deepseek-v3-671b": ("experts_shifted", "w_o_scales_shifted"),
               "qwen3-14b": ("page_scales_local", "wo_heads_shifted")}
# phase (h)'s MoE-layer check: this many decode-shaped tokens of unit-rms
# hidden state through the first MoE layer (``moe_layer_out``)
MOE_CHECK_TOKENS = 8
# single-device streams of phase (c), by path (for phase (h))
SERVED = {}
# phase (h)'s dual-microbatch decode (``decode_overlap=True``) on one
# device, graphed, on the dense ring: DeepSeek-V3 at phase (c)'s depth cut
# without the draft, and qwen3-14b whole; each op's launches a dual step
# (twice the single step's; qwen3-14b's dense-ring decode runs no kernel
# of the port)
OVERLAP_ENGINE = dict(paged=False, attn_impl="pallas")
OVERLAP_STEP = {"deepseek-v3-671b": {"fp8_gemm": 58, "moe_gemm": 6,
                                     "mla_decode": 8},
                "qwen3-14b": {}}
# the first dual step's logits against the single step's on the same cache,
# max err over max|logit| and least cosine: the mesh's limits (a half-batch
# changes cuBLAS's algorithm and the split plans, as the mesh reorders its
# sums; at published widths one ulp flips E4M3 codes downstream)
OVERLAP_LIMITS = {"deepseek-v3-671b": (0.1, 0.995),
                  "qwen3-14b": (0.04, 0.9993)}
# the meshed dual decode: DeepSeek-V3 on the dense ring at (1, 4), ep_flat,
# FP8 wire, with and without overlap; then the cross-mesh disaggregator:
# prefill on (1, 4), decode on (1, 2) over ranks 0-1, paged fp8 and dense
DISAGG_DECODE_MESH = (1, 2)
DISAGG_RUNS = (("paged", PAGED), ("dense", OVERLAP_ENGINE))


def mesh_rank(rank, store_path, out_path):
    """One rank of phase (h), in a spawned process: builds the meshed
    engine of each run of ``MESH_RUNS`` on its shard, serves phase (c)'s
    requests, measures, and writes JSON to ``out_path``. Raises (exit code
    1) on any fault."""
    t_start = time.time()
    sys.path.insert(0, str(ROOT / "src"))
    import zlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import registry
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.context import Mesh, ParallelCtx
    from repro_torch.serve.engine import Request, ServeEngine, bucket_length

    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", rank=rank, world_size=MESH_WORLD,
                            store=dist.FileStore(store_path, MESH_WORLD))
    mesh = Mesh.create(MESH)
    # every rank creates the decode mesh's groups, in the same order
    dmesh = Mesh.create(DISAGG_DECODE_MESH,
                        ranks=range(math.prod(DISAGG_DECODE_MESH)))
    inputs = json.loads((pathlib.Path(store_path).parent
                         / "mesh_in.json").read_text())
    res = {"rank": rank, "t_start": t_start, "t_ready": time.time(),
           "runs": {}}
    params = {}
    for model, wire in MESH_RUNS:
        spec = PATHS[model]
        cfg = get_config(spec["model"], **spec["overrides"])
        ctx = ParallelCtx(mesh=mesh, moe_impl="ep_flat" if cfg.moe else
                          "local", wire=wire or "fp8")
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params=params.get(model), slots=4,
                          max_len=spec["max_len"], device="cuda", seed=0,
                          ctx=ctx, **spec["engine"])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        params = {model: eng.params}
        reqs = [Request(i, np.asarray(p, np.int32), max_new=MESH_NEW[model])
                for i, p in enumerate(inputs[model]["prompts"])]
        for r in reqs:
            eng.submit(r)
        dist.barrier()
        registry.reset_launch_counts()
        coll.reset_counters()
        ticks = []
        t0 = time.perf_counter()
        while eng.has_work():
            before = (eng.stats["prefills"], eng.stats["steps"],
                      sum(coll.SECONDS.values()), coll.BYTES["all_to_all"],
                      registry.launch_counts())
            t1 = time.perf_counter()
            eng.step()
            after = registry.launch_counts()
            ticks.append((time.perf_counter() - t1,
                          eng.stats["prefills"] - before[0],
                          eng.stats["steps"] - before[1],
                          sum(coll.SECONDS.values()) - before[2],
                          coll.BYTES["all_to_all"] - before[3],
                          {k: after[k] - before[4][k] for k in after}))
            if len(ticks) > 200:
                raise AssertionError("meshed run did not finish in 200 "
                                     "ticks")
        wall = time.perf_counter() - t0
        run_counts = registry.launch_counts()
        # ticks that ran the decode chunk and no prefill; each ran the
        # chunk's every step (a finished slot's lane is masked, not cut):
        # their launches a step, and the prefill ticks' launches a prefill
        # of the kernels that run only in prefill
        decode = [t for t in ticks if t[1] == 0 and t[2] > 0]
        steps = len(decode) * eng.chunk
        step_counts = [{k: t[5][k] / eng.chunk for k in MESH_STEP[model]}
                       for t in decode]
        prefill_counts = [{k: t[5][k] / t[1] for k in
                           MESH_PREFILL.get(model, {})}
                          for t in ticks if t[1] > 0]
        moe_layers = sum(seg.n for seg in eng.model.segments
                         if seg.kind == "moe")
        # the longest prompt's prefill, timed, three runs
        p = reqs[-1].prompt
        bucket = bucket_length(len(p), spec["max_len"])
        ptoks = np.zeros((1, bucket), np.int32)
        ptoks[0, :len(p)] = p
        prefill_ms = []
        for i in range(MESH_PREFILL_RUNS):
            dist.barrier()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.model.prefill(eng.params, {"tokens": torch.as_tensor(ptoks)},
                              lengths=[len(p)], pctx=ctx)
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t1))
        ref = reference_logits(torch, eng, inputs[model], spec["max_len"],
                               pctx=ctx)
        if rank == 0:
            np.savez(f"{out_path}.{model}.{wire}.npz", **ref)
        # the gate's other side: the same logits with a fault planted
        # (each fault fails the decode step's or the MoE layer's reading:
        # the prefill logits are not replayed under it)
        for fault in MESH_FAULTS[model] if wire != "fp8" else ():
            with plant_fault(torch, fault, eng, ctx):
                ref = reference_logits(torch, eng, inputs[model],
                                       spec["max_len"], pctx=ctx,
                                       prefill=False)
            if rank == 0:
                np.savez(f"{out_path}.{model}.{fault}.npz", **ref)
        outs = [list(map(int, r.out)) for r in reqs]
        mirrors = zlib.crc32(np.concatenate([
            eng.positions, eng._tokens, eng._left, eng._tix,
            np.asarray([t for o in outs for t in o], np.int32)]).tobytes())
        res["runs"][f"{model} {wire}"] = dict(
            outs=outs, done=all(r.done for r in reqs),
            leaked=eng.pool_pages - eng.free_pages(),
            trace_counts=eng.trace_counts, build_s=build_s, wall_s=wall,
            ticks=len(ticks), run_counts=run_counts, step_counts=step_counts,
            prefill_counts=prefill_counts, prefill_ms=prefill_ms,
            prefill_len=len(p),
            decode_ms_step=1e3 * sum(t[0] for t in decode) / max(steps, 1),
            coll_ms_step=1e3 * sum(t[3] for t in decode) / max(steps, 1),
            decode_steps=steps,
            a2a_claimed=eng.decode_alltoall_bytes(),
            a2a_step_layer=(sum(t[4] for t in decode) / max(steps, 1)
                            / max(moe_layers, 1)),
            mirrors=mirrors, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            bytes=dict(coll.BYTES))
        del eng
        if model == "deepseek-v3-671b" and wire == "fp8":
            res["overlap"] = mesh_overlap(torch, mesh, params[model],
                                          inputs[model])
        if model != "deepseek-v3-671b" or wire == "fp8":
            params = {}
        gc_cuda(torch)
    res["disagg"] = mesh_disagg(torch, mesh, dmesh,
                                inputs["deepseek-v3-671b"])
    pathlib.Path(out_path).write_text(json.dumps(res))
    dist.destroy_process_group()


def overlap_step_logits(torch, eng, served, pctx=None):
    """One decode step over four slots admitted with the first four served
    prompts, fed each request's served first token at its prompt length
    (``reference_logits``'s inputs): the single step's logits, then the
    dual step's (``overlap.dual_decode_step`` on the cache's halves) on
    the same cache, each ``(4, V)`` fp32 on the host. The engine is left
    empty."""
    import numpy as np
    from repro_torch.parallel import context, overlap
    from repro_torch.serve.engine import Request
    model, params, dev = eng.model, eng.params, eng.device
    reqs = [Request(200 + i, np.asarray(p, np.int32), max_new=2)
            for i, p in enumerate(served["prompts"][:4])]
    for r in reqs:
        eng.add_request(r)
    toks = torch.tensor([[o[0]] for o in served["outs"][:4]],
                        dtype=torch.int32, device=dev)
    pos = torch.tensor([[len(p)] for p in served["prompts"][:4]],
                       dtype=torch.int32, device=dev)
    one, _ = model.decode_step(params, eng.cache, toks, pos, pctx=pctx)
    halfA, halfB = overlap.cache_halves(model, eng.cache)
    with torch.no_grad(), context.use(pctx):
        la, lb, _, _ = overlap.dual_decode_step(
            model, params, halfA, halfB, toks[:2], toks[2:], pos[:2],
            pos[2:])
    for r in reqs:
        eng.cancel(r.rid)
    return (one[:, 0].float().cpu().numpy(),
            torch.cat([la, lb])[:, 0].float().cpu().numpy())


def serve_all(eng, prompts, max_new=32, limit=400):
    """Serve ``prompts`` through ``eng`` to the end; returns the requests
    and the ticks taken."""
    import numpy as np
    from repro_torch.serve.engine import Request
    reqs = [Request(i, np.asarray(p, np.int32), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = 0
    while eng.has_work():
        eng.step()
        ticks += 1
        if ticks > limit:
            raise AssertionError(f"not finished in {limit} ticks")
    return reqs, ticks


def phase_overlap_single(torch):
    """Phase (h), one device: ``ServeEngine(decode_overlap=True)`` on the
    dense ring, graphed (``OVERLAP_STEP``'s paths), beside the single path
    on the same weights, on phase (c)'s prompts. Gates (fatal): every
    request done on both; each engine's decode chunk captured once
    (``trace_counts["decode"] == 1``); each kernel's launches a dual step,
    read off one replay's tally, exactly twice the single step's and equal
    to ``OVERLAP_STEP``; the first dual step's logits within
    ``OVERLAP_LIMITS`` of the single step's on the same cache. Printed:
    graphed ms/step at the steady contexts in turns (single, dual, dual,
    single), where each dual stream first parts from the single one, and a
    profile of one graphed chunk of each."""
    from repro_torch.configs.base import get_config
    from repro_torch.serve.engine import ServeEngine
    out = {}
    for name, want in OVERLAP_STEP.items():
        path = PATHS[name]
        cfg = get_config(path["model"], **path["overrides"])
        kw = dict(slots=4, max_len=path["max_len"], device="cuda", seed=0,
                  **OVERLAP_ENGINE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        single = ServeEngine(cfg, **kw)
        dual = ServeEngine(cfg, params=single.params, decode_overlap=True,
                           **kw)
        torch.cuda.synchronize()
        log(f"[h] {name}, one device, dense ring {OVERLAP_ENGINE}, 4 slots: "
            f"single and dual engines up in {time.perf_counter() - t0:.2f} "
            "s on one set of weights")
        steps, streams = {}, {}
        for label, eng in (("single", single), ("dual", dual)):
            t0 = time.perf_counter()
            reqs, ticks = serve_all(eng, SERVED[name]["prompts"])
            wall = time.perf_counter() - t0
            ch = eng._decode
            steps[label] = {k: c / ch.k for k, c in ch.tally.items() if c}
            streams[label] = [list(map(int, r.out)) for r in reqs]
            log(f"[h] {name} {label}: {len(reqs)} requests served in "
                f"{wall:.3f} s over {ticks} ticks; trace_counts "
                f"{eng.trace_counts}; capture {ch.capture_s:.3f} s + "
                f"instantiation {ch.instantiate_s:.3f} s; launches a step "
                f"(one replay's tally over {ch.k} steps) {steps[label]}")
            if not all(r.done and len(r.out) == 32 for r in reqs):
                raise AssertionError(f"[h] {name} {label}: a request "
                                     "unfinished")
            if eng.trace_counts["decode"] != 1:
                raise AssertionError(f"[h] {name} {label}: trace_counts "
                                     f"{eng.trace_counts}, want one capture")
        if steps["dual"] != {k: 2 * c for k, c in steps["single"].items()} \
                or any(steps["dual"].get(k) != c for k, c in want.items()):
            raise AssertionError(f"[h] {name}: launches a step, dual "
                                 f"{steps['dual']}, single {steps['single']}"
                                 f"; want dual {want}, twice the single's")
        parts = [first_diff(a, b) for a, b in zip(streams["single"],
                                                  streams["dual"])]
        one, two = overlap_step_logits(torch, dual, SERVED[name])
        a = logit_agreement(two, one)
        err, cos = OVERLAP_LIMITS[name]
        log(f"[h] {name}: the first dual step's logits vs the single step's "
            f"on the same cache: max err {a['err']:.5f} of max|logit| (rows "
            f"{a['rows_err']}), least cosine {a['cos']:.6f}, greedy tokens "
            f"equal {a['argmax']}/{a['rows']} (limits err <= {err}, cos >= "
            f"{cos}); free-running greedy streams, dual vs single, first "
            f"differing token per request {parts} (printed, not gated)")
        if a["err"] > err or a["cos"] < cos:
            raise AssertionError(f"[h] {name}: dual step logits off the "
                                 "single step's")
        for eng in (single, dual):
            steady_state(torch, eng, path)
        host = steady_host(path)
        ms = {"single": [], "dual": []}
        for label in ("single", "dual", "dual", "single"):
            eng = single if label == "single" else dual
            ms[label].append(chunk_ms(torch, eng._decode, host, True))
        log(f"[h] {name}: graphed steady decode, 4 slots at contexts "
            f"{path['steady']} x {single._decode.k} steps, in turns (single, "
            f"dual, dual, single): single {[round(x, 3) for x in ms['single']]}"
            f" ms/step, dual {[round(x, 3) for x in ms['dual']]} ms/step; "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        for label, eng in (("single", single), ("dual", dual)):
            profile_device(torch, f"phase (h) {name} {label}: one graphed "
                           f"{eng._decode.k}-step chunk",
                           lambda: eng._decode(host), eng._decode.k, "step")
        out[name] = dict(ms=ms, steps=steps, parts=parts, logits=a)
        # the chunks hold the weights, the rings and the graph pools
        del single, dual, eng, ch
        gc_cuda(torch)
    return out


def mesh_overlap(torch, mesh, params, served):
    """Phase (h) in a mesh rank: DeepSeek-V3 on the dense ring at (1, 4),
    ``ep_flat``, FP8 wire, on the rank's placed weights, single and dual
    (``decode_overlap=True``) engines. Each serves phase (c)'s requests;
    then, at the steady contexts, one eager chunk each in turns (single,
    dual, dual, single) under ``collectives.record()``: ms a step, the
    all-to-alls and their bytes a MoE layer and step, the host's seconds
    inside staged collectives, and the seconds a half's collective was in
    flight while the other half's work was queued; and the first dual
    step's logits against the single step's. Returns them (gated by
    ``phase_mesh``)."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import registry
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.engine import ServeEngine
    name = "deepseek-v3-671b"
    path = PATHS[name]
    cfg = get_config(path["model"], **path["overrides"])
    ctx = ParallelCtx(mesh=mesh, moe_impl="ep_flat", wire="fp8")
    kw = dict(slots=4, max_len=path["max_len"], device="cuda", seed=0,
              ctx=ctx, params=params, **OVERLAP_ENGINE)
    engines = {"single": ServeEngine(cfg, **kw),
               "dual": ServeEngine(cfg, decode_overlap=True, **kw)}
    moe = sum(seg.n for seg in engines["single"].model.segments
              if seg.kind == "moe")
    out = {}
    for label, eng in engines.items():
        dist.barrier()
        t0 = time.perf_counter()
        reqs, ticks = serve_all(eng, served["prompts"])
        out[label] = dict(outs=[list(map(int, r.out)) for r in reqs],
                          done=all(r.done for r in reqs),
                          served_s=time.perf_counter() - t0, ticks=ticks,
                          claimed=eng.decode_alltoall_bytes(), turns=[])
        steady_state(torch, eng, path)
    host = steady_host(path)
    for label in ("single", "dual", "dual", "single"):
        eng = engines[label]
        dist.barrier()
        coll.reset_counters()
        registry.reset_launch_counts()
        torch.cuda.synchronize()
        with coll.record() as rec:
            t0 = time.perf_counter()
            eng._decode(host)
            wall = time.perf_counter() - t0
        a2a = rec.collectives("all_to_all")
        k = eng._decode.k
        out[label]["turns"].append(dict(
            ms=1e3 * wall / k, launches={
                n: c / k for n, c in registry.launch_counts().items() if c},
            a2a=len(a2a) / (k * moe),
            a2a_bytes=sum(e.nbytes for e in a2a) / (k * moe),
            staged_s=sum(coll.SECONDS.values()) / k,
            in_flight_s=rec.in_flight_s() / k,
            collectives=len(rec.collectives()) / k))
    one, two = overlap_step_logits(torch, engines["dual"], served, pctx=ctx)
    out["logits"] = logit_agreement(two, one)
    del engines, eng
    return out


def mesh_disagg(torch, mesh, dmesh, served):
    """Phase (h) in a mesh rank: cross-mesh disaggregation on DeepSeek-V3,
    prefill on ``mesh`` (every rank), decode on ``dmesh`` (ranks 0-1),
    ``ep_flat``, FP8 wire, paged fp8 and dense (``DISAGG_RUNS``), each on
    weights drawn for it from the seed (one parameter set, placed by each
    mesh's rules), phase (c)'s requests. Returns per run what the rank
    saw: on the decode mesh or not, every request done, the streams, the
    handoff bytes and the sum of ``cache_nbytes`` over the payloads it
    queued, launches, seconds, peak memory."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import registry
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.disagg import Disaggregator, cache_nbytes
    from repro_torch.serve.engine import Request
    import numpy as np
    path = PATHS["deepseek-v3-671b"]
    cfg = get_config(path["model"], **path["overrides"])
    out = {}
    for label, engine in DISAGG_RUNS:
        gc_cuda(torch)
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        dis = Disaggregator(
            cfg, decode_slots=4, max_len=path["max_len"], device="cuda",
            prefill_ctx=ParallelCtx(mesh=mesh, moe_impl="ep_flat"),
            ctx=ParallelCtx(mesh=dmesh, moe_impl="ep_flat"), **engine)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reqs = [Request(i, np.asarray(p, np.int32), max_new=32)
                for i, p in enumerate(served["prompts"])]
        dist.barrier()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        wire = 0
        for r in reqs:
            dis.submit(r)
            if dis.decode is not None:
                wire += cache_nbytes(dis.queue[-1].cache1)
        dis.run()
        torch.cuda.synchronize()
        out[label] = dict(
            decode=dis.decode is not None, cross=dis.cross_mesh,
            done=all(r.done for r in reqs), build_s=build_s,
            wall_s=time.perf_counter() - t0,
            outs=[list(map(int, r.out)) for r in reqs],
            handoff=dis.handoff_bytes, wire=wire,
            counts=registry.launch_counts(),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del dis
    gc_cuda(torch)
    return out


def _swap_leaves(tree, pick, make, saved):
    for k, v in tree.items():
        if isinstance(v, dict):
            _swap_leaves(v, pick, make, saved)
        elif pick(k, v):
            saved.append((tree, k, v))
            tree[k] = make(v)


@contextlib.contextmanager
def plant_fault(torch, fault, eng, ctx):
    """One of ``MESH_FAULTS`` planted on this rank's meshed engine for a
    block, in place, then taken out:

    - ``experts_shifted``: model column 1's local expert map off by one
      (each of its routed experts computes with its neighbour's weights);
    - ``w_o_scales_shifted``: column 1's slice of every attention output
      projection reads the block scales one 128-row block over (a shard
      cut off by one block);
    - ``wo_heads_shifted``: column 1's slice of every GQA output
      projection one head over (its heads' outputs meet the wrong rows);
    - ``page_scales_local``: each rank's FP8 page scales taken over its
      own KV heads, not over the model group's (``layers.kv_amax_reduce``
      skipped: a fault this port had)."""
    import dataclasses
    from repro_torch.core.fp8 import Fp8Experts, Fp8Weight
    from repro_torch.models import layers
    saved, col1 = [], ctx.index(ctx.tp_axis) == 1
    if fault == "experts_shifted" and col1:
        _swap_leaves(eng.params, lambda k, v: k in ("w1", "w2", "w3"),
                     lambda v: dataclasses.replace(
                         v, wq=torch.roll(v.wq.view(torch.uint8), 1,
                                          v.wq.dim() - 5).view(v.wq.dtype),
                         ws=torch.roll(v.ws, 1, v.ws.dim() - 3))
                     if isinstance(v, Fp8Experts) else torch.roll(
                         v, 1, v.dim() - 3), saved)
    elif fault == "w_o_scales_shifted" and col1:
        _swap_leaves(eng.params,
                     lambda k, v: k == "w_o" and isinstance(v, Fp8Weight),
                     lambda v: Fp8Weight(v.w, v.wq, torch.roll(
                         v.ws, 1, v.ws.dim() - 2)), saved)
    elif fault == "wo_heads_shifted" and col1:
        hd = eng.cfg.head_dim_()
        _swap_leaves(eng.params,
                     lambda k, v: k == "wo" and isinstance(v, torch.Tensor),
                     lambda v: torch.roll(v, hd, v.dim() - 2), saved)
    elif fault == "page_scales_local":
        saved.append((vars(layers), "kv_amax_reduce", layers.kv_amax_reduce))
        layers.kv_amax_reduce = lambda nkv, cfg: None
    elif fault not in ("experts_shifted", "w_o_scales_shifted",
                       "wo_heads_shifted"):
        raise ValueError(fault)
    try:
        yield
    finally:
        for tree, k, v in saved:
            tree[k] = v


@contextlib.contextmanager
def four_partials(torch, n):
    """On one device, every row-parallel product (``linear(..., tp="row")``:
    the attention output projections and the dense FFN's ``w_down``; the
    shared expert's ``ws2``) computed as a mesh of ``n`` model columns
    computes it: ``n`` fp32 partial products over contiguous K slices
    (FP8: ``matmul_qdq`` on the slice's codes and block scales), summed in
    column order and rounded once. Phase (h)'s witness: the same weights
    and inputs as the single device, the sums reordered and nothing
    else."""
    from repro_torch.core import fp8, mla, moe
    from repro_torch.models import layers
    from repro_torch.parallel import context as pctx
    base_linear, base_shared = layers.linear, moe.shared_expert

    def k_slices(w):
        per = w.shape[-2] // n
        if isinstance(w, fp8.Fp8Weight):
            if per % fp8.BLOCK:
                raise ValueError(f"K {w.shape[-2]} over {n} cuts a block")
            b = per // fp8.BLOCK
            return [fp8.Fp8Weight(w.w[..., i * per:(i + 1) * per, :],
                                  fp8.k_major(w.wq[..., i * per:(i + 1) * per,
                                                   :]),
                                  w.ws[..., i * b:(i + 1) * b, :])
                    for i in range(n)]
        return [w[..., i * per:(i + 1) * per, :] for i in range(n)]

    def summed(x, w, one):
        per = x.shape[-1] // n
        y = None
        for i, wi in enumerate(k_slices(w)):
            t = one(x[..., i * per:(i + 1) * per].contiguous(), wi)
            y = t if y is None else y + t
        return y.to(x.dtype)

    def linear(x, w, cfg=None, b=None, tp=None):
        if tp != "row" or pctx.get().tp_group is not None:
            return base_linear(x, w, cfg, b, tp)
        if cfg is not None and cfg.fp8 and w.ndim == 2 and x.shape[-1] >= 256:
            if x.shape[-1] // n % fp8.TILE:
                raise ValueError(f"K {x.shape[-1]} over {n} cuts a tile")
            y = summed(x, w, lambda xi, wi: fp8.matmul_qdq(
                xi, wi, cfg.fp8_impl))
        else:
            y = summed(x, w, lambda xi, wi: torch.matmul(
                xi.float(), layers.raw(wi).float()))
        return y if b is None else y + b.to(y.dtype)

    def shared_expert(p, x, cfg, weights_qdq=False):
        if "ws1" not in p or pctx.get().tp_group is not None:
            return base_shared(p, x, cfg, weights_qdq)
        w1, w3, w2 = p["ws1"], p["ws3"], p["ws2"]
        if cfg.fp8:
            x = moe.ste_qdq_tile(x)
            if not weights_qdq:
                w1, w3, w2 = map(moe.ste_qdq_block, (w1, w3, w2))
        dt = x.dtype
        h = layers.act_fn(cfg.act)(x @ w1.to(dt)) * (x @ w3.to(dt))
        return summed(h, w2, lambda hi, wi: hi.float() @ wi.float())

    layers.linear = mla.linear = linear
    moe.shared_expert = shared_expert
    try:
        yield
    finally:
        layers.linear = mla.linear = base_linear
        moe.shared_expert = base_shared


def witness(torch, eng, name, reqs):
    """Phase (h)'s witness on phase (c)'s engine: ``reference_logits`` and
    the served streams (eager chunk) again under ``four_partials``."""
    from repro_torch.serve.engine import Request, ServeEngine
    spec = PATHS[name]
    with four_partials(torch, MESH_WORLD):
        out = reference_logits(torch, eng, SERVED[name], spec["max_len"])
        twin = ServeEngine(eng.cfg, params=eng.params, slots=eng.slots,
                           max_len=eng.max_len, device=eng.device, seed=0,
                           **spec["engine"])
        twin._decode.graphed = False
        twins = [Request(r.rid, r.prompt, max_new=r.max_new, seed=r.seed)
                 for r in reqs]
        for r in twins:
            twin.submit(r)
        twin.run_until_done()
        del twin
    out["outs"] = [list(map(int, r.out)) for r in twins]
    return out


def moe_check_input(torch, cfg, device):
    """``MOE_CHECK_TOKENS`` decode-shaped tokens ``(B, 1, d)`` of unit-rms
    bf16 hidden state, from a fixed seed."""
    g = torch.Generator(device=device).manual_seed(26)
    return torch.randn((MOE_CHECK_TOKENS, 1, cfg.d_model), generator=g,
                       device=device).to(torch.bfloat16)


def moe_layer_out(torch, eng, x, pctx=None):
    """The routed experts' part of the first MoE layer's output on ``x``
    (the layer without its shared expert) through the model's own
    dispatch (``transformer._ffn``: ``moe_ffn`` on one device,
    ``ep.moe_ffn_sharded`` under an EP ctx), on the engine's weights,
    ``(tokens, d)`` fp32 on the host. At published widths the routed
    experts' weights are drawn about 16x smaller than the shared
    expert's (their fan-in counts the expert axis, the reference's init
    rule), so they barely move the logits and the logit gate cannot see
    them: this check holds their part of the layer itself."""
    from repro_torch.models import param, transformer
    from repro_torch.parallel import context
    seg = next(s for s in eng.model.segments if s.kind == "moe")
    p = param.layer(eng.params[seg.name], 0)
    p = dict(p, moe={k: v for k, v in p["moe"].items()
                     if k not in ("ws1", "ws2", "ws3")})
    with context.use(pctx):
        y, _ = transformer._ffn(p, x, eng.cfg,
                                eng.model._ctx(eng.params, stats=False))
    return y.float().cpu().numpy().reshape(-1, y.shape[-1])


def reference_logits(torch, eng, served, max_len, pctx=None, prefill=True):
    """The logits phase (h) holds the meshed engine to, on this engine
    (phase (c)'s, or a rank's meshed one): with ``prefill``, the bucketed
    prefill of each of the served prompts, ``(n, V)``; one decode step over four slots
    admitted with the first four prompts, fed each request's served first
    token at its prompt length, ``(4, V)`` (the same inputs on both sides
    whatever token each prefill picks); on a model with experts, the first
    MoE layer's output on ``moe_check_input`` (``moe_out``). The engine
    is left empty."""
    import numpy as np
    from repro_torch.serve.engine import Request, bucket_length
    model, params = eng.model, eng.params
    pre = []
    for p in served["prompts"] if prefill else ():
        toks = np.zeros((1, bucket_length(len(p), max_len)), np.int32)
        toks[0, :len(p)] = p
        logits, _ = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                                  lengths=[len(p)], pctx=pctx)
        pre.append(logits[0, -1].float().cpu().numpy())
    reqs = [Request(100 + i, np.asarray(p, np.int32), max_new=2)
            for i, p in enumerate(served["prompts"][:4])]
    for r in reqs:
        eng.add_request(r)
    dev = eng.device
    toks = torch.tensor([[o[0]] for o in served["outs"][:4]],
                        dtype=torch.int32, device=dev)
    pos = torch.tensor([[len(p)] for p in served["prompts"][:4]],
                       dtype=torch.int32, device=dev)
    step, _ = model.decode_step(params, eng.cache, toks, pos, pctx=pctx)
    step = step[:, 0].float().cpu().numpy()
    for r in reqs:
        eng.cancel(r.rid)
    out = {"step_logits": step}
    if prefill:
        out["prefill_logits"] = np.stack(pre)
    if eng.cfg.moe:
        out["moe_out"] = moe_layer_out(torch, eng, moe_check_input(
            torch, eng.cfg, dev), pctx)
    return out


def logit_agreement(ours, ref):
    """Max abs error over max|ref| and the least cosine, over rows; the
    greedy token agreement; the median top-2 gap of ``ref`` over max|ref|
    (how near the ties the noise meets are)."""
    import numpy as np
    scale = np.abs(ref).max()
    coss = [float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
            for a, b in zip(ours, ref)]
    cos = min(coss)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    return dict(err=float(np.abs(ours - ref).max() / scale), cos=cos,
                rows_err=[round(float(e), 5) for e in
                          np.abs(ours - ref).max(-1) / scale],
                rows_cos=[round(c, 6) for c in coss],
                argmax=int((ours.argmax(-1) == ref.argmax(-1)).sum()),
                rows=len(ref),
                gap=float(np.median(top2[:, 1] - top2[:, 0]) / scale))


# phase (h)'s logit gate, per model: max |err| over max|logit| and least
# cosine of the meshed engine's logits against phase (c)'s single device,
# same weights and inputs (one decode step and every prompt's prefill).
# Each limit lies between the sound readings (the mesh, and the witness
# ``four_partials``: one device with its row-parallel sums reordered as
# the mesh's) and the planted faults' (``MESH_FAULTS``), about their
# geometric mean; every run prints all of them and fails if a fault
# passes. On one H100 (PERF.md, PR 26): DeepSeek-V3 sound <= 0.0714 and
# >= 0.99761, the witness alone 0.0550; ``w_o_scales_shifted`` 0.1475 and
# 0.98950. qwen3-14b sound <= 0.0260 and >= 0.99967; ``page_scales_local``
# 0.0564 and 0.99833. At published widths in bf16 with E4M3 activations
# a one-ulp change from a reordered sum flips E4M3 codes downstream, so
# the sound readings are this large on one device too (the witness).
MESH_LIMITS = {"deepseek-v3-671b": (0.1, 0.995),
               "qwen3-14b": (0.04, 0.9993)}
# the MoE-layer check's limit (``moe_layer_out``), DeepSeek-V3: sound
# bitwise equal (0.0), ``experts_shifted`` 0.862 and cosine 0.636
MOE_LIMITS = (0.01, 0.9999)


def match_frac(a, b):
    toks = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in toks) / len(toks)


def phase_mesh(torch, card):
    """Phase (h): ``ServeEngine(ctx=ParallelCtx(mesh=(1, 4), ...))`` on
    four gloo ranks sharing the card (``mesh_rank``), on phase (c)'s
    weights and prompts. Gates: every request done and no page leaked on
    any rank; the launches of every decode tick of the served run, over
    its steps (``MESH_STEP``), and of every prefill tick, over its
    prefills (``MESH_PREFILL``); every kernel of the path launched in the
    run; the decode chunk eager (``trace_counts["decode"] == 0``); every
    rank's mirrors and streams one CRC; one decode step's logits and every
    prompt's prefill logits within ``MESH_LIMITS`` of phase (c)'s single
    device on the same inputs, the routed experts' part of the first MoE
    layer within ``MOE_LIMITS``, and every planted fault (``MESH_FAULTS``)
    outside them (``mesh_logit_gate``). Printed besides: the witness's
    readings, the free-running greedy streams' agreement, seconds to
    spawn, draw and prepare, peak memory per rank, eager ms a decode step
    and its share inside staged collectives, the decode all-to-all bytes,
    the longest prompt's prefill ms. The data axis has one row here, so
    the pools' equality across data rows holds trivially (the CPU tests
    run two)."""
    import tempfile
    gc_cuda(torch)
    t0 = time.time()
    phase_overlap_single(torch)
    gc_cuda(torch)
    log(f"[h] dual-microbatch decode on one device: {time.time() - t0:.1f} "
        f"s; {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved here "
        "before the ranks start")
    log(f"[h] mesh-sharded serving: {MESH_WORLD} gloo ranks sharing the "
        f"card ({card}), mesh {MESH} (data, model); runs {MESH_RUNS}, then "
        f"DeepSeek-V3 on the dense ring with and without decode overlap, "
        f"then cross-mesh disaggregation (prefill {MESH}, decode "
        f"{DISAGG_DECODE_MESH} over ranks 0-"
        f"{math.prod(DISAGG_DECODE_MESH) - 1}) {[r for r, _ in DISAGG_RUNS]}")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        (pathlib.Path(tmp) / "mesh_in.json").write_text(json.dumps(
            {m: {k: SERVED[m][k][:MESH_PROMPTS[m]] for k in ("prompts",
                                                             "outs")}
             for m, _ in MESH_RUNS}))
        codes, outs = run_ranks(mesh_rank, MESH_WORLD, tmp, 900)
        if codes != [0] * MESH_WORLD:
            raise AssertionError(f"mesh ranks exited with {codes}")
        res = [json.loads(pathlib.Path(o).read_text()) for o in outs]
        import numpy as np
        logits = {}
        for model, wire in MESH_RUNS:
            logits[f"{model} {wire}"] = dict(np.load(
                f"{outs[0]}.{model}.{wire}.npz"))
            for fault in MESH_FAULTS[model] if wire != "fp8" else ():
                logits[f"{model} {fault}"] = dict(np.load(
                    f"{outs[0]}.{model}.{fault}.npz"))
    log(f"[h] {MESH_WORLD} ranks done in {time.time() - t0:.1f} s; spawn "
        "to process group, s per rank: "
        f"{[round(r['t_ready'] - t0, 2) for r in res]}")
    bad = []
    for key in res[0]["runs"]:
        model, wire = key.split()
        runs = [r["runs"][key] for r in res]
        spec = PATHS[model]
        for r, run in enumerate(runs):
            if not run["done"] or run["leaked"]:
                bad.append(f"{key} rank {r}: done {run['done']}, "
                           f"{run['leaked']} pages leaked")
            if run["trace_counts"]["decode"] != 0:
                bad.append(f"{key}: a gloo mesh captured its decode chunk")
            for k in spec["kernels"]:
                if run["run_counts"][k] <= 0:
                    bad.append(f"{key} rank {r}: kernel {k} never launched")
            for what, want, got in (
                    ("a decode step", MESH_STEP[model], run["step_counts"]),
                    ("a prefill", MESH_PREFILL.get(model), run[
                        "prefill_counts"])):
                if want and (not got or any(c != want for c in got)):
                    bad.append(f"{key} rank {r}: launches {what}, tick by "
                               f"tick of the served run, {got}; want {want}")
            for o in run["outs"]:
                if len(o) != MESH_NEW[model] or min(o) < 0 or \
                        max(o) >= get_vocab(model):
                    bad.append(f"{key}: bad stream {o[:8]}")
        if len({run["mirrors"] for run in runs}) != 1:
            bad.append(f"{key}: ranks' mirrors differ: "
                       f"{[run['mirrors'] for run in runs]}")
        log(f"[h] {key}: every request done, no page leaked, mirrors one "
            f"CRC over ranks, decode chunk eager (trace_counts "
            f"{runs[0]['trace_counts']}); launches per rank, each decode "
            "tick of the served run over its steps: "
            f"{[sorted({json.dumps(c) for c in run['step_counts']}) for run in runs]}"
            + (f"; each prefill tick over its prefills: "
               f"{[sorted({json.dumps(c) for c in run['prefill_counts']}) for run in runs]}"
               if model in MESH_PREFILL else ""))
        bad += mesh_logit_gate(key, logits, runs[0]["outs"])
        log(f"[h] {key}: engine build (draw this rank's slices + "
            f"load-time preparation) s per rank "
            f"{[round(run['build_s'], 2) for run in runs]}; peak memory GB "
            f"per rank {[round(run['peak_gb'], 2) for run in runs]}; served "
            f"in {runs[0]['wall_s']:.2f} s over {runs[0]['ticks']} ticks")
        log(f"[h] {key}: eager decode ms a step (ticks without a prefill, "
            f"{runs[0]['decode_steps']} steps; the ranks share the card, so "
            "a collective's wall holds its wait for the other ranks' "
            "kernels) per rank "
            f"{[round(run['decode_ms_step'], 2) for run in runs]}, of which "
            "inside staged collectives "
            f"{[round(run['coll_ms_step'], 2) for run in runs]}; prefill of "
            f"the {runs[0]['prefill_len']}-token prompt ms "
            f"({MESH_PREFILL_RUNS} run(s), rank 0) "
            f"{[round(x, 2) for x in runs[0]['prefill_ms']]}")
        if wire != "None":
            log(f"[h] {key}: decode_alltoall_bytes() per rank "
                f"{[run['a2a_claimed'] for run in runs]}; all-to-all bytes "
                "moved a decode step a MoE layer, counted "
                f"{[round(run['a2a_step_layer'], 1) for run in runs]}; "
                f"collective bytes of the run, rank 0: {runs[0]['bytes']}")
    bad += mesh_overlap_gate(torch, res)
    bad += mesh_disagg_gate(torch, res)
    if bad:
        raise AssertionError("[h] " + "; ".join(bad))
    return res


def mesh_overlap_gate(torch, res):
    """The meshed dual decode's gates (``mesh_overlap``): every request
    done on every rank; in each timed chunk, each kernel's launches a dual
    step ``OVERLAP_STEP``'s and twice the single step's, the all-to-alls a
    MoE layer and step exactly twice the single path's, their bytes in
    [1x, 2x] of its and each path's equal to its
    ``decode_alltoall_bytes()``; the
    first dual step's logits within ``MESH_LIMITS`` of the single-scan
    mesh's; every rank's dual streams alike. Prints the figures."""
    bad = []
    key = "deepseek-v3-671b dense ring, ep_flat, fp8 wire"
    ovs = [r["overlap"] for r in res]
    for r, ov in enumerate(ovs):
        s, d = ov["single"], ov["dual"]
        if not (s["done"] and d["done"]):
            bad.append(f"{key} rank {r}: a request unfinished")
        for ts, td in zip(s["turns"], d["turns"]):
            want = OVERLAP_STEP["deepseek-v3-671b"]
            if td["launches"] != want or td["launches"] != {
                    n: 2 * c for n, c in ts["launches"].items()}:
                bad.append(f"{key} rank {r}: launches a step, dual "
                           f"{td['launches']}, single {ts['launches']}; "
                           f"want dual {want}, twice the single's")
            if not (ts["a2a"] > 0 and td["a2a"] == 2 * ts["a2a"]):
                bad.append(f"{key} rank {r}: all-to-alls a MoE layer and "
                           f"step, dual {td['a2a']}, single {ts['a2a']}")
            if not (ts["a2a_bytes"] <= td["a2a_bytes"]
                    <= 2 * ts["a2a_bytes"]) or \
                    td["a2a_bytes"] != d["claimed"] or \
                    ts["a2a_bytes"] != s["claimed"]:
                bad.append(f"{key} rank {r}: all-to-all bytes a MoE layer "
                           f"and step, dual {td['a2a_bytes']} (claimed "
                           f"{d['claimed']}), single {ts['a2a_bytes']} "
                           f"(claimed {s['claimed']})")
        if ov["dual"]["outs"] != ovs[0]["dual"]["outs"]:
            bad.append(f"{key}: rank {r}'s dual streams differ from rank 0's")
    ov = ovs[0]
    a = ov["logits"]
    err, cos = MESH_LIMITS["deepseek-v3-671b"]
    log(f"[h] {key}: the first dual step's logits vs the single-scan mesh's "
        f"on the same cache: max err {a['err']:.5f} of max|logit| (rows "
        f"{a['rows_err']}), least cosine {a['cos']:.6f}, greedy tokens equal "
        f"{a['argmax']}/{a['rows']} (limits err <= {err}, cos >= {cos})")
    if a["err"] > err or a["cos"] < cos:
        bad.append(f"{key}: dual step logits off the single-scan mesh's")
    parts = [first_diff(x, y) for x, y in zip(ov["single"]["outs"],
                                              ov["dual"]["outs"])]
    log(f"[h] {key}: served {len(parts)} requests, single "
        f"{ov['single']['served_s']:.2f} s / dual {ov['dual']['served_s']:.2f}"
        f" s (rank 0); dual vs single greedy streams, first differing token "
        f"per request {parts} (printed, not gated)")
    for label in ("single", "dual"):
        t = [o[label]["turns"] for o in ovs]
        log(f"[h] {key} {label}: eager steady chunk in turns (single, dual, "
            "dual, single), per rank: ms a step "
            f"{[[round(x['ms'], 2) for x in tt] for tt in t]}; host s a step "
            "inside staged collectives "
            f"{[[round(x['staged_s'], 4) for x in tt] for tt in t]}; s a "
            "step a half's collective was in flight while the other half's "
            "work was queued "
            f"{[[round(x['in_flight_s'], 4) for x in tt] for tt in t]}; "
            f"launches a step {t[0][0]['launches']}, "
            f"collectives a step {t[0][0]['collectives']}, all-to-alls a "
            f"MoE layer and step {t[0][0]['a2a']}, their bytes "
            f"{t[0][0]['a2a_bytes']} (decode_alltoall_bytes() "
            f"{ovs[0][label]['claimed']})")
    return bad


def mesh_disagg_gate(torch, res):
    """The cross-mesh disaggregator's gates (``mesh_disagg``): every rank
    cross-mesh, on the decode mesh exactly the decode ranks; there every
    request done, ``handoff_bytes`` equal to the sum of ``cache_nbytes``
    over the payloads queued (and > 0), the decode path's kernels
    launched; on a prefill-only rank the prefill's; peak memory a rank
    under the card's. Prints the streams against phase (c)'s."""
    bad = []
    cap = torch.cuda.get_device_properties(0).total_memory / 1e9
    n_dec = math.prod(DISAGG_DECODE_MESH)
    handoff = {}
    for label, engine in DISAGG_RUNS:
        runs = [r["disagg"][label] for r in res]
        attn = "paged_mla_decode" if engine.get("paged") else "mla_decode"
        for r, run in enumerate(runs):
            on = r < n_dec
            need = ("fp8_gemm", "moe_gemm") + ((attn,) if on else ())
            if run["decode"] != on or not run["cross"]:
                bad.append(f"disagg {label} rank {r}: decode "
                           f"{run['decode']}, cross_mesh {run['cross']}")
            if on and not (run["done"] and run["handoff"] == run["wire"] > 0):
                bad.append(f"disagg {label} rank {r}: done {run['done']}, "
                           f"handoff_bytes {run['handoff']} vs the payloads' "
                           f"{run['wire']}")
            for k in need:
                if run["counts"][k] <= 0:
                    bad.append(f"disagg {label} rank {r}: {k} never "
                               "launched")
            if run["peak_gb"] >= cap:
                bad.append(f"disagg {label} rank {r}: peak {run['peak_gb']}"
                           f" GB over the card's {cap}")
        one = SERVED["deepseek-v3-671b"]["outs"]
        outs = runs[0]["outs"]
        handoff[label] = runs[0]["handoff"]
        log(f"[h] cross-mesh disagg {label}: build (two engines) s per rank "
            f"{[round(x['build_s'], 2) for x in runs]}, served in "
            f"{runs[0]['wall_s']:.2f} s (rank 0); handoff_bytes "
            f"{runs[0]['handoff']} (the payloads' cache_nbytes "
            f"{runs[0]['wire']}); peak GB per rank "
            f"{[round(x['peak_gb'], 2) for x in runs]}; launches rank 0 "
            f"{ {k: c for k, c in runs[0]['counts'].items() if c} }, rank "
            f"{n_dec} (prefill only) "
            f"{ {k: c for k, c in runs[n_dec]['counts'].items() if c} }; "
            f"streams vs phase (c)'s single device: tokens equal "
            f"{match_frac(one, outs):.4f}, first differing token per "
            f"request {[first_diff(a, b) for a, b in zip(one, outs)]} "
            "(printed, not gated)")
    log(f"[h] cross-mesh disagg: handoff_bytes paged fp8 {handoff['paged']}"
        f" vs dense {handoff['dense']}")
    return bad


def mesh_logit_gate(key, logits, outs):
    """Phase (h)'s logit gate on one run (``MESH_LIMITS``; the MoE-layer
    check, ``MOE_LIMITS``), its witness and its planted faults, each of
    which must fail one of the readings; prints every reading, returns
    the failures.
    Also prints the free-running greedy streams' agreement (mesh, witness
    and single device), which is not gated: at published widths a
    reordered sum parts greedy streams within a few tokens (the witness
    shows it on one device)."""
    model, wire = key.split()
    one, wit = SERVED[model], SERVED[model]["witness"]
    bad = []

    def reading(what, ours, ref, limits=MESH_LIMITS[model]):
        err, cos = limits
        a = logit_agreement(ours, ref[:len(ours)])    # the run's prompts
        ok = a["err"] <= err and a["cos"] >= cos
        log(f"[h] {key}: {what}: max err {a['err']:.5f} of max|ref| "
            f"(rows {a['rows_err']}), least cosine {a['cos']:.6f} (rows "
            f"{a['rows_cos']})" + ("" if limits is MOE_LIMITS else
                                   f", greedy tokens equal {a['argmax']}/"
                                   f"{a['rows']}")
            + f"; within the gate (err <= {err}, cos >= {cos}): {ok}")
        return ok

    for part, what in (("step_logits", "one decode step's logits (4 slots, "
                        "the served first tokens at the prompts' ends)"),
                       ("prefill_logits", "each prompt's prefill logits")):
        if not reading(f"{what}, mesh vs single device", logits[key][part],
                       one[part]):
            bad.append(f"{key}: {part} off the single device's")
        reading(f"{what}, witness vs single device", wit[part], one[part])
        reading(f"{what}, mesh vs witness", logits[key][part], wit[part])
    moe = "moe_out" in one
    if moe and not reading(
            f"the routed experts' part of the first MoE layer on "
            f"{MOE_CHECK_TOKENS} tokens, mesh vs single device", logits[key]["moe_out"], one["moe_out"],
            MOE_LIMITS):
        bad.append(f"{key}: the MoE layer off the single device's")
    log(f"[h] {key}: the single device's median top-2 gap "
        f"{logit_agreement(one['step_logits'], one['step_logits'])['gap']:.5f}"
        " of max|logit| (decode step)")
    for fault in MESH_FAULTS[model] if wire != "fp8" else ():
        f = logits[f"{model} {fault}"]
        caught = [not reading(f"planted fault {fault}, {part} vs single "
                              "device", f[part], one[part])
                  for part in ("step_logits", "prefill_logits") if part in f]
        if moe:
            caught.append(not reading(
                f"planted fault {fault}, the routed experts' part of the "
                "MoE layer vs single device",
                f["moe_out"], one["moe_out"], MOE_LIMITS))
        if not any(caught):
            bad.append(f"{key}: the gate passes planted fault {fault}")
    # the single device and the witness served 32 tokens, the mesh
    # MESH_NEW[model]: compared over the mesh's
    n = len(outs[0])
    one = dict(outs=[o[:n] for o in one["outs"]])
    wit = dict(outs=[o[:n] for o in wit["outs"]])
    log(f"[h] {key}: free-running greedy streams ({n} tokens x "
        f"{len(outs)}), tokens equal: mesh vs single device "
        f"{match_frac(one['outs'], outs):.4f}, witness vs single device "
        f"{match_frac(one['outs'], wit['outs']):.4f}, mesh vs witness "
        f"{match_frac(wit['outs'], outs):.4f}; first differing token per "
        "request, mesh vs single device "
        f"{[first_diff(a, b) for a, b in zip(one['outs'], outs)]}, witness "
        "vs single device "
        f"{[first_diff(a, b) for a, b in zip(one['outs'], wit['outs'])]} "
        "(printed, not gated)")
    return bad


# phase (i): the meshed train step, 4 gloo ranks sharing the card.
# (i.1) DeepSeek-V3's dense prefix at published widths cut to one dense
# layer plus the MTP module, bf16, FP8 through fp8_gemm, at (2, 2): FSDP
# over data and TP over model both cut; the dual microbatch engages
# (global batch 4 = 2 x dp x 1)
MESH_TRAIN = dict(model="deepseek-v3-671b",
                  overrides=dict(family="dense", moe=None, num_layers=1,
                                 fp8_impl="pallas"),
                  seq_len=256, global_batch=4, steps=3, peak_lr=3e-4,
                  warmup=2, mesh=(2, 2))
MESH_TRAIN_WORLD = 4
# the faults' runs stop after the step-1 update the gate reads
MESH_TRAIN_FAULT_STEPS = 2
# elements of each leaf whose step-1 update the gate compares (a seeded
# sample of the leaf's logical indices; all of a smaller leaf)
UPDATE_SAMPLES = 1 << 16
# (i.2) smoke DeepSeek-V3 with its MoE layers, fp32, capacity 8: runs
# (name, mesh, moe_impl, wire), each 3 steps against one device on the
# card; the reference's bounds: losses 5e-3, the FP8 wire within 5% of
# the fp32 wire
MESH_TRAIN_SMOKE = (("ep_flat fp32", (2, 2), "ep_flat", "fp32"),
                    ("ep_flat fp8", (2, 2), "ep_flat", "fp8"),
                    ("ep_dedup fp32", (1, 4), "ep_dedup", "fp32"))
SMOKE_TRAIN = dict(global_batch=8, seq_len=16, steps=3, peak_lr=1e-3,
                   warmup=2, total_steps=10, loss_tol=5e-3, wire_tol=0.05)
# (i.3) pipeline_forward on ("pipe",) of the 4 ranks: the reference's case
PIPE_CASE = dict(P=4, M=8, mb=2, d=16, fwd_tol=1e-5, grad_tol=1e-4)


def _tdev():
    """Phase (i)'s device: the card. ``CHIP_SMOKE_TRAIN_DEVICE=cpu`` runs
    its functions on the CPU at smoke width (a rehearsal of the code
    paths; the card's gates on launches and memory are skipped there)."""
    return os.environ.get("CHIP_SMOKE_TRAIN_DEVICE", "cuda")


def _tcard():
    return _tdev() == "cuda"


def _tsync(torch):
    if _tcard():
        torch.cuda.synchronize()


def _tpeak(torch, reset=False):
    if not _tcard():
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 1e9


def _tgc(torch):
    if _tcard():
        gc_cuda(torch)


def mesh_train_config():
    from repro_torch.configs.base import get_config, smoke_config
    cfg = get_config(MESH_TRAIN["model"], **MESH_TRAIN["overrides"])
    if not _tcard():
        import dataclasses
        cfg = dataclasses.replace(smoke_config(cfg), dtype="bfloat16",
                                  param_dtype="bfloat16")
    return cfg


def smoke_moe_train_config():
    import dataclasses
    from repro_torch.configs.base import get_config, smoke_config
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    return dataclasses.replace(cfg, fp8=False, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def sample_index(np, path, shape):
    """The step-1 update's sampled elements of a leaf: (k, ndim) logical
    indices, seeded by the leaf's path (every element of a small leaf)."""
    import zlib
    n = math.prod(shape)
    if n <= UPDATE_SAMPLES:
        flat = np.arange(n)
    else:
        flat = np.random.default_rng(zlib.crc32("/".join(path).encode())
                                     ).integers(0, n, UPDATE_SAMPLES)
    return np.stack(np.unravel_index(flat, shape), axis=1).astype(np.int64)


def master_samples(torch, np, tree, pspecs=None, mesh=None):
    """{path: the master copy at ``sample_index``} (fp32, on the host); the
    step-1 update is the difference of two of them. Meshed (``pspecs``,
    ``mesh``): ``tree`` is a rank's shards; each rank reads the samples
    inside its region and the parts are summed over the axes that cut the
    leaf, so every rank holds the whole sample."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import at_path, region_of
    from repro_torch.train.optimizer import tree_items
    out = {}
    for path, a in tree_items(tree):
        spec = (None,) * a.dim() if pspecs is None else tuple(
            at_path(pspecs, path))
        shape = tuple(n * _parts(mesh, e) for n, e in zip(a.shape, spec))
        idx = torch.from_numpy(sample_index(np, path, shape)).to(a.device)
        if pspecs is None:
            out["/".join(path)] = a[tuple(idx.T)].float().cpu().numpy()
            continue
        reg = region_of(shape, spec, mesh)
        lo = torch.tensor([r[0] for r in reg], device=a.device)
        hi = torch.tensor([r[1] for r in reg], device=a.device)
        inside = ((idx >= lo) & (idx < hi)).all(dim=1)
        vals = torch.zeros(idx.shape[0], device=a.device)
        vals[inside] = a[tuple((idx[inside] - lo).T)].float()
        for e in spec:
            if e is not None and mesh.shape[e] > 1:
                vals = coll.all_gather(vals[None], mesh.groups[e]).sum(0)
        out["/".join(path)] = vals.cpu().numpy()
    return out


def sampled_update(before, after):
    return {k: (after[k] - before[k]).tolist() for k in after}


def _parts(mesh, entry):
    return 1 if entry is None else mesh.shape[entry]


@contextlib.contextmanager
def planted_train_fault(fault, data_index):
    """Phase (i.1)'s planted faults in a meshed rank:
    ``data_rank_dropped`` leaves data rank 1's gradients out of the
    data-axis reduction (its reduce-scatter inputs and replicated-leaf
    gradients enter as zeros); ``copy_to_group_skipped`` makes
    ``collectives.copy_to_group`` the identity (a column-parallel input's
    backward all-reduce never runs)."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.train import trainer
    saved = (coll.reduce_scatter, coll.copy_to_group,
             trainer._reduce_over_data)
    rs, _, red = saved
    drop = data_index == 1
    if fault == "data_rank_dropped":
        coll.reduce_scatter = lambda x, group, dim=0: rs(
            x * 0 if drop else x, group, dim)

        def reduce(grads, specs, group):
            if drop:
                grads[:] = [None if g is None else g * 0 for g in grads]
            red(grads, specs, group)
        trainer._reduce_over_data = reduce
    else:
        coll.copy_to_group = lambda x, group: x
    try:
        yield
    finally:
        (coll.reduce_scatter, coll.copy_to_group,
         trainer._reduce_over_data) = saved


@contextlib.contextmanager
def mesh_witness(model, params):
    """One device with its sums reordered as the (2, 2) mesh's: each
    row-parallel product (``w_o``, ``w_down``) as two fp32 partials over
    the halves of its contraction, summed, then rounded; each
    column-parallel one (``w_uq``, ``w_uk``, ``w_uv``, ``w_gate``,
    ``w_up``) as two products over the halves of its outputs, so the
    backward sums two partial dx. Weights are told apart by their layer
    slices' data pointers. (The data axis and the dual halves are
    reordered by ``witness_step``.)"""
    import torch
    from repro_torch.core import fp8
    from repro_torch.models import layers as Lyr
    from repro_torch.models.param import layer
    from repro_torch.train.optimizer import tree_items
    ptrs = {"row": set(), "col": set()}
    kinds = {"w_o": "row", "w_down": "row", "w_uq": "col", "w_uk": "col",
             "w_uv": "col", "w_gate": "col", "w_up": "col"}
    for path, t in tree_items(params):
        if path[-1] in kinds and t.dim() == 3:
            for i in range(t.shape[0]):
                ptrs[kinds[path[-1]]].add(layer(t, i).data_ptr())
    orig = Lyr.linear

    def linear(x, w, cfg=None, b=None, tp=None):
        ptr = Lyr.raw(w).data_ptr()
        if ptr in ptrs["row"]:
            k = x.shape[-1] // 2
            fp8_path = cfg is not None and cfg.fp8 and x.shape[-1] >= 256
            ys = []
            for h in (slice(0, k), slice(k, None)):
                if fp8_path:
                    ys.append(fp8.fp8_linear(x[..., h], w[h], cfg.fp8_impl,
                                             out_fp32=True))
                else:
                    ys.append(torch.matmul(x[..., h].float(), w[h].float()))
            y = (ys[0] + ys[1]).to(x.dtype)
            return y if b is None else y + b.to(y.dtype)
        if ptr in ptrs["col"]:
            n = w.shape[-1] // 2
            return torch.cat([orig(x, w[:, h], cfg) for h in (
                slice(0, n), slice(n, None))], dim=-1) + (
                    0 if b is None else b.to(x.dtype))
        return orig(x, w, cfg, b, tp)

    mods = [Lyr, __import__("repro_torch.core.mla", fromlist=["mla"]),
            __import__("repro_torch.core.mtp", fromlist=["mtp"])]
    saved = [(m, m.linear) for m in mods]
    for m in mods:
        m.linear = linear
    try:
        yield
    finally:
        for m, f in saved:
            m.linear = f


def witness_step(model, tc):
    """The one-device step of the witness: the loss as the (2, 2) mesh
    splits it (each data rank's rows, halved into the dual microbatch,
    at its share of the global count), the two data ranks' gradients
    summed in fp32, then AdamW on them (``optimizer.update``)."""
    import torch
    from repro_torch.train import optimizer as optim
    from repro_torch.train import schedule as sched
    from repro_torch.train.trainer import _tree_of

    def step_fn(params, opt_state, batch, step):
        items = optim.tree_items(params)
        leaves = [t for _, t in items]
        for t in leaves:
            t.requires_grad_(True)
        B = batch["tokens"].shape[0]
        per = B // MESH_TRAIN["mesh"][0]
        grads, loss_v = None, 0.0
        n_all = (batch["labels"] >= 0).sum()
        try:
            for d in range(MESH_TRAIN["mesh"][0]):
                rows = {k: v[d * per:(d + 1) * per] for k, v in batch.items()}
                share = (rows["labels"] >= 0).sum() / n_all
                loss, _ = model.loss_dual(
                    params, {k: v[0::2] for k, v in rows.items()},
                    {k: v[1::2] for k, v in rows.items()})
                g = torch.autograd.grad(loss * share, leaves,
                                        allow_unused=True)
                loss_v = loss_v + float(loss.detach() * share)
                grads = ([None if x is None else x.float() for x in g]
                         if grads is None else
                         [a if x is None else a + x.float()
                          for a, x in zip(grads, g)])
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [None if g is None else g.to(t.dtype)
                 for g, t in zip(grads, leaves)]
        lr = sched.warmup_cosine(step, peak_lr=tc.peak_lr, warmup=tc.warmup,
                                 total=tc.total_steps)
        params, opt_state, ostats = optim.update(
            _tree_of(items, grads), opt_state, params, lr=lr,
            weight_decay=tc.weight_decay, clip_norm=tc.clip_norm)
        out = dict(ostats, loss=torch.tensor(loss_v))
        return params, opt_state, out

    return step_fn


def one_device_train(torch, np, cfg, tc, data, steps, witness=False):
    """``steps`` Trainer steps on one device from the seed's weights;
    keeps on the host only the losses, grad norms, the step-1 update's
    samples and the step times, and frees the rest."""
    from repro_torch.train.trainer import Trainer
    tr = Trainer(cfg, tc, data=data, device=_tdev())
    ctx = (mesh_witness(tr.model, tr.params) if witness
           else contextlib.nullcontext())
    if witness:
        tr._step_fn = witness_step(tr.model, tc)
    ms, seen = [], []
    with ctx:
        for i in range(steps):
            _tsync(torch)
            t0 = time.perf_counter()
            tr.run(1)
            _tsync(torch)
            ms.append(1e3 * (time.perf_counter() - t0))
            if i < 2:
                seen.append(master_samples(torch, np, tr.opt_state.master))
    samples = sampled_update(*seen)
    h = tr.history
    out = dict(loss=[x["loss"] for x in h],
               grad_norm=[x["grad_norm"] for x in h], samples=samples, ms=ms,
               peak_gb=_tpeak(torch))
    del tr
    _tgc(torch)
    return out


def train_mesh_rank(rank, store_path, out_path):
    """One rank of phase (i), in a spawned process: (i.1) the published-
    width dense prefix at (2, 2), sound and under each planted fault;
    (i.2) smoke DeepSeek-V3 with its MoE layers on ``MESH_TRAIN_SMOKE``,
    then the re-mesh run; (i.3) ``pipeline_forward``. Writes JSON."""
    # four ranks share the card: let each allocator return what it frees
    # between the gathers' transients (set before CUDA starts here)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import registry
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.context import Mesh, ParallelCtx
    from repro_torch.train import optimizer as optim
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.trainer import Trainer, TrainConfig

    torch.set_num_threads(2)
    if _tcard():
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", rank=rank, world_size=MESH_TRAIN_WORLD,
                            store=dist.FileStore(store_path,
                                                 MESH_TRAIN_WORLD))
    meshes = {(2, 2): Mesh.create((2, 2)), (1, 4): Mesh.create((1, 4)),
              "pipe": Mesh.create((MESH_TRAIN_WORLD,), ("pipe",))}
    res = {"rank": rank, "runs": {}}

    # (i.1)
    cfg = mesh_train_config()
    mesh = meshes[MESH_TRAIN["mesh"]]
    tc = TrainConfig(peak_lr=MESH_TRAIN["peak_lr"],
                     warmup=MESH_TRAIN["warmup"],
                     total_steps=MESH_TRAIN["steps"])
    data = SyntheticCorpus(cfg.vocab_size, MESH_TRAIN["seq_len"],
                           MESH_TRAIN["global_batch"], seed=tc.seed)
    for run in ("sound",) + MESH_TRAIN_FAULTS:
        _tgc(torch)
        _tpeak(torch, reset=True)
        dist.barrier()
        t0 = time.perf_counter()
        tr = Trainer(cfg, tc, data=data, ctx=ParallelCtx(mesh=mesh),
                     device=_tdev())
        _tsync(torch)
        r = dict(build_s=time.perf_counter() - t0)
        if run == "sound":
            r["dtypes"] = sorted({f"{k}:{t.dtype}" for k, tree in (
                ("param", tr.params), ("master", tr.opt_state.master),
                ("m", tr.opt_state.m), ("v", tr.opt_state.v))
                for _, t in optim.tree_items(tree)})
            r["params"] = sum(t.numel() for _, t in
                              optim.tree_items(tr.params))
        steps = (MESH_TRAIN["steps"] if run == "sound"
                 else MESH_TRAIN_FAULT_STEPS)
        pspecs = tr.state_pspecs()["params"]
        fault = (contextlib.nullcontext() if run == "sound" else
                 planted_train_fault(run, mesh.coords["data"]))
        seen, counts, ms, coll_s, data_bytes = [], [], [], [], []
        with fault:
            for i in range(steps):
                registry.reset_launch_counts()
                coll.reset_counters()
                dist.barrier()
                _tsync(torch)
                t1 = time.perf_counter()
                tr.run(1)
                _tsync(torch)
                ms.append(1e3 * (time.perf_counter() - t1))
                counts.append(registry.launch_counts())
                coll_s.append(sum(coll.SECONDS.values()))
                data_bytes.append(dict(coll.BYTES))
                if i < 2:
                    seen.append(master_samples(torch, np,
                                               tr.opt_state.master, pspecs,
                                               mesh))
        r["samples"] = sampled_update(*seen)
        h = tr.history
        r.update(loss=[x["loss"] for x in h],
                 grad_norm=[x["grad_norm"] for x in h], ms=ms,
                 counts=counts, coll_s=coll_s, bytes=data_bytes,
                 peak_gb=_tpeak(torch))
        res["runs"]["i1 " + run] = r
        del tr
    _tgc(torch)

    # (i.2)
    scfg = smoke_moe_train_config()
    stc = TrainConfig(peak_lr=SMOKE_TRAIN["peak_lr"],
                      warmup=SMOKE_TRAIN["warmup"],
                      total_steps=SMOKE_TRAIN["total_steps"])
    for name, shape, impl, wire in MESH_TRAIN_SMOKE:
        tr = Trainer(scfg, stc, global_batch=SMOKE_TRAIN["global_batch"],
                     seq_len=SMOKE_TRAIN["seq_len"], device=_tdev(),
                     ctx=ParallelCtx(mesh=meshes[shape], moe_impl=impl,
                                     wire=wire))
        out = tr.run(SMOKE_TRAIN["steps"])
        res["runs"]["i2 " + name] = dict(
            loss=[x["loss"] for x in out["history"]])
        del tr
    ckdir = str(pathlib.Path(store_path).parent / "remesh_ckpt")
    tr = Trainer(scfg, TrainConfig(
        peak_lr=SMOKE_TRAIN["peak_lr"], warmup=SMOKE_TRAIN["warmup"],
        total_steps=8, ckpt_dir=ckdir, ckpt_every=2),
        injector=FailureInjector({3: "node"}),
        global_batch=SMOKE_TRAIN["global_batch"],
        seq_len=SMOKE_TRAIN["seq_len"], device=_tdev(),
        ctx=ParallelCtx(mesh=meshes[(2, 2)], moe_impl="ep_flat"))
    out = tr.run(6)
    res["remesh"] = {k: out[k] for k in ("final_step", "restarts",
                                         "mesh_shape", "left")}
    del tr
    _tgc(torch)

    # (i.3)
    from repro_torch.parallel.pipeline import pipeline_forward
    pm = meshes["pipe"]
    c = PIPE_CASE
    g = torch.Generator(device=_tdev()).manual_seed(0)
    Ws = torch.randn(c["P"], c["d"], c["d"], generator=g,
                     device=_tdev()) * 0.3
    x = torch.randn(c["M"], c["mb"], c["d"], generator=g, device=_tdev())
    s = pm.coords["pipe"]

    def stage(w, v):
        return torch.tanh(v @ w)

    w = Ws[s].clone().requires_grad_(True)
    y = pipeline_forward(stage, w, x, pm)
    g1, = torch.autograd.grad((y ** 2).sum(), [w])
    W2 = Ws.clone().requires_grad_(True)
    ref = x
    for i in range(c["P"]):
        ref = stage(W2[i], ref)
    g2, = torch.autograd.grad((ref ** 2).sum(), [W2])
    res["pipe"] = dict(fwd=float((y - ref).abs().max()),
                       grad=float((g1 - g2[s]).abs().max()
                                  / g2.abs().max()))
    res["peak_gb"] = _tpeak(torch)
    pathlib.Path(out_path).write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def phase_train_mesh(torch, card):
    """Phase (i), the meshed train step (``Trainer(ctx=ParallelCtx(
    mesh=...))``) on four gloo ranks sharing the card
    (``train_mesh_rank``). First, in this process, the one-device runs it
    is held to: (i.1)'s config from the same seed-drawn weights and its
    witness (``mesh_witness``, ``witness_step``), then (i.2)'s smoke
    config; each freed before the spawn. Gates (fatal): (i.1) every step
    finite; fp8_gemm launched exactly 2 x 3 x the FP8 linears of a
    forward (``fp8_linears``) a rank and step, no other kernel; fp32
    master and bf16 m, v on every rank; the sound run and the witness
    pass ``train_gate`` against the one-device run, each planted fault
    fails it; peak memory a rank and all ranks' sum under the card's.
    (i.2) every run's losses within 5e-3 of one device, the FP8 wire
    within 5% of the fp32 wire; the re-mesh run ends at (1, 2) after one
    restart with ranks 2-3 gone. (i.3) forward 1e-5, gradients 1e-4
    relative. Printed: ms a step a rank, host s inside staged
    collectives, bytes gathered and reduce-scattered over data a step,
    launches. Returns the fp8_gemm launches a rank and step."""
    import tempfile

    import numpy as np
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.models.api import Model
    from repro_torch.train.trainer import Trainer, TrainConfig
    t_phase = time.time()
    _tgc(torch)
    cfg = mesh_train_config()
    tc = TrainConfig(peak_lr=MESH_TRAIN["peak_lr"],
                     warmup=MESH_TRAIN["warmup"],
                     total_steps=MESH_TRAIN["steps"])
    data = SyntheticCorpus(cfg.vocab_size, MESH_TRAIN["seq_len"],
                           MESH_TRAIN["global_batch"], seed=tc.seed)
    _tpeak(torch, reset=True)
    one = one_device_train(torch, np, cfg, tc, data, MESH_TRAIN["steps"])
    wit = one_device_train(torch, np, cfg, tc, data, MESH_TRAIN["steps"],
                           witness=True)
    log(f"[i.1] one device ({cfg.name} dense prefix cut to 1 layer + MTP, "
        f"{MESH_TRAIN['global_batch']} x {MESH_TRAIN['seq_len']} tokens a "
        f"step): losses {[round(v, 5) for v in one['loss']]}, grad norms "
        f"{[round(v, 4) for v in one['grad_norm']]}, ms a step "
        f"{[round(v, 1) for v in one['ms']]}, peak {one['peak_gb']:.2f} GB; "
        f"the witness: losses {[round(v, 5) for v in wit['loss']]}, grad "
        f"norms {[round(v, 4) for v in wit['grad_norm']]}")
    scfg = smoke_moe_train_config()
    st = SMOKE_TRAIN
    str_ = Trainer(scfg, TrainConfig(peak_lr=st["peak_lr"],
                                     warmup=st["warmup"],
                                     total_steps=st["total_steps"]),
                   global_batch=st["global_batch"], seq_len=st["seq_len"],
                   device=_tdev())
    smoke_one = [x["loss"] for x in str_.run(st["steps"])["history"]]
    del str_
    _tgc(torch)
    per_fwd = fp8_linears(Model(cfg, device="meta"))
    want_fp8 = 2 * 3 * per_fwd
    log(f"[i] {MESH_TRAIN_WORLD} gloo ranks sharing the card ({card}), "
        f"(i.1) at {MESH_TRAIN['mesh']}; one-device runs took "
        f"{time.time() - t_phase:.1f} s; this process holds "
        f"{torch.cuda.memory_reserved() / 1e9 if _tcard() else 0:.2f} GB "
        "of the card before the spawn")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        codes, outs = run_ranks(train_mesh_rank, MESH_TRAIN_WORLD, tmp, 900)
        if codes != [0] * MESH_TRAIN_WORLD:
            raise AssertionError(f"phase (i) ranks exited with {codes}")
        res = [json.loads(pathlib.Path(o).read_text()) for o in outs]
    log(f"[i] ranks done in {time.time() - t0:.1f} s")
    bad = []
    total = (torch.cuda.get_device_properties(0).total_memory / 1e9
             if _tcard() else math.inf)
    sound = [r["runs"]["i1 sound"] for r in res]
    want_dt = ["m:torch.bfloat16", "master:torch.float32",
               "param:torch.bfloat16", "v:torch.bfloat16"]
    for k, run in enumerate(sound):
        if run["dtypes"] != want_dt:
            bad.append(f"rank {k}: state dtypes {run['dtypes']}")
        if not all(math.isfinite(v) for v in run["loss"] + run["grad_norm"]):
            bad.append(f"rank {k}: a step not finite {run['loss']}")
        for i, c in enumerate(run["counts"] if _tcard() else ()):
            if c.get("fp8_gemm") != want_fp8 or any(
                    v for n, v in c.items() if n != "fp8_gemm"):
                bad.append(f"rank {k} step {i}: launches {c}, want "
                           f"fp8_gemm {want_fp8} only")
    peak_sum = sum(max(r["runs"][f"i1 {x}"]["peak_gb"]
                       for x in ("sound",) + MESH_TRAIN_FAULTS)
                   for r in res)
    if max(r["peak_gb"] for r in res) >= total or peak_sum >= total:
        bad.append(f"peak memory {[r['peak_gb'] for r in res]} GB a rank, "
                   f"{peak_sum:.2f} together, the card {total:.2f}")
    ref_s = one["samples"]
    figs = {}
    for label, run in [("mesh", sound[0]), ("witness", wit)] + [
            (f, res[0]["runs"][f"i1 {f}"]) for f in MESH_TRAIN_FAULTS]:
        n = len(run["loss"])
        ok, fig = train_gate(
            dict(loss=one["loss"][:n], grad_norm=one["grad_norm"][:n]),
            run, leaf_cosines(np, ref_s, run["samples"]))
        figs[label] = fig
        want_ok = label in ("mesh", "witness")
        if ok != want_ok:
            bad.append(f"(i.1) {label}: gate {'passed' if ok else 'failed'}"
                       f" {fig}")
        log(f"[i.1] {label} vs one device: loss max rel err "
            f"{fig['loss']:.3g} (limit {MESH_TRAIN_LIMITS['loss']:g}), grad "
            f"norm {fig['grad_norm']:.3g} (limit "
            f"{MESH_TRAIN_LIMITS['grad_norm']:g}), least step-1 update "
            f"cosine {fig['cos']:.6f} at {fig['worst']} (limit "
            f"{MESH_TRAIN_LIMITS['cos']:g}): "
            f"{'passes' if ok else 'fails'}")
    for k, run in enumerate(sound):
        steady = run["ms"][1:]
        b = run["bytes"][-1]
        log(f"[i.1] rank {k}: {run['params']} parameters a rank, built in "
            f"{run['build_s']:.1f} s; losses "
            f"{[round(v, 5) for v in run['loss']]}; ms a step "
            f"{[round(v, 1) for v in run['ms']]} (steps 2-3 mean "
            f"{np.mean(steady):.1f}); host s a step inside staged "
            f"collectives {[round(v, 3) for v in run['coll_s']]}; bytes a "
            f"step (last): all_gather {b.get('all_gather', 0)}, "
            f"reduce_scatter {b.get('reduce_scatter', 0)}, all_reduce "
            f"{b.get('all_reduce', 0)}, exchange {b.get('exchange', 0)}; "
            f"launches a step {run['counts'][-1]} (want fp8_gemm "
            f"{want_fp8} = 2 halves x 3 x {per_fwd}); peak "
            f"{run['peak_gb']:.2f} GB")
    log(f"[i.1] peak GB a rank over its runs "
        f"{[round(r['peak_gb'], 2) for r in res]}, sum of the ranks' "
        f"{peak_sum:.2f} of the card's {total:.2f}")
    # (i.2)
    fp32 = None
    for name, shape, _, wire in MESH_TRAIN_SMOKE:
        for k, r in enumerate(res):
            got = r["runs"]["i2 " + name]["loss"]
            d = max(abs(a - b) for a, b in zip(got, smoke_one))
            if not all(math.isfinite(v) for v in got):
                bad.append(f"(i.2) {name} rank {k}: losses {got}")
            if wire != "fp8" and d >= st["loss_tol"]:
                bad.append(f"(i.2) {name} rank {k}: losses {got} vs one "
                           f"device {smoke_one}")
        got = res[0]["runs"]["i2 " + name]["loss"]
        if name == "ep_flat fp32":
            fp32 = got
        rel = (max(abs(a - b) / abs(a) for a, b in zip(fp32, got))
               if fp32 else None)
        if wire == "fp8" and not rel < st["wire_tol"]:
            bad.append(f"(i.2) {name}: {rel} of the fp32 wire")
        log(f"[i.2] {name} at {shape}: losses {[round(v, 5) for v in got]}"
            f" (one device {[round(v, 5) for v in smoke_one]}; max abs diff "
            f"{max(abs(a - b) for a, b in zip(got, smoke_one)):.3g}"
            + (f", {rel:.3g} of the fp32 wire" if wire == "fp8" else "")
            + ")")
    rm = [r["remesh"] for r in res]
    want_rm = [dict(final_step=6, restarts=1, mesh_shape=[1, 2], left=False)
               ] * 2
    if rm[:2] != want_rm or not all(x["left"] and x["mesh_shape"] == [1, 2]
                                    for x in rm[2:]):
        bad.append(f"(i.2) re-mesh: {rm}")
    log(f"[i.2] Trainer at (2, 2) with checkpoints and FailureInjector({{3: "
        f"node}}): {rm}")
    pipe = [r["pipe"] for r in res]
    if any(p["fwd"] >= PIPE_CASE["fwd_tol"] or p["grad"] >= PIPE_CASE[
            "grad_tol"] for p in pipe):
        bad.append(f"(i.3) pipeline {pipe}")
    log(f"[i.3] pipeline_forward over ('pipe',) of {MESH_TRAIN_WORLD} on "
        f"the card: forward max err {[p['fwd'] for p in pipe]} (tol "
        f"{PIPE_CASE['fwd_tol']:g}), gradients "
        f"{[p['grad'] for p in pipe]} of the largest (tol "
        f"{PIPE_CASE['grad_tol']:g})")
    log(f"[i] phase (i) {time.time() - t_phase:.1f} s")
    if bad:
        raise AssertionError("phase (i): " + "; ".join(bad))
    return want_fp8


# phase (i.1)'s gate, the meshed train step against the one-device run of
# the same config from the same weights and batches: each step's loss and
# grad norm within these relative errors, and the least cosine over the
# leaves of the step-1 update (master after step 1 - after step 0; step 0
# runs at lr 0) at least ``cos``. Set between the sound runs (the mesh and
# the witness, one device with its sums reordered as the mesh's: grad
# norms within 1.25e-3, cosines 0.9786 and above) and the planted faults
# (``MESH_TRAIN_FAULTS``: grad norms 0.40-0.58 off, cosines 0.45 and
# below), PR 28 call 2 on one H100; the losses of the faults' two steps
# (the first at lr 0) move by 1.5e-5, so the loss limit is a bound on
# sound runs (1.1e-3 seen), not a fault detector. PERF.md §6, PR 28.
MESH_TRAIN_LIMITS = dict(loss=1e-2, grad_norm=2e-2, cos=0.9)
MESH_TRAIN_FAULTS = ("data_rank_dropped", "copy_to_group_skipped")


def leaf_cosines(np, ref, got):
    """{path: cosine} of two {path: array} trees of updates (in float64;
    a leaf whose both updates are zero counts 1)."""
    out = {}
    for path, a in ref.items():
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(got[path], np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        out[path] = (1.0 if na == nb == 0 else
                     float(a @ b / max(na * nb, 1e-300)))
    return out


def train_gate(ref, got, cosines, limits=MESH_TRAIN_LIMITS):
    """Phase (i.1)'s gate (``MESH_TRAIN_LIMITS``): ``ref`` and ``got`` hold
    per-step ``loss`` and ``grad_norm``; ``cosines`` the step-1 update's
    cosine by leaf. Returns (passed, figures)."""
    def rel(key):
        return max(abs(a - b) / abs(b) for a, b in zip(got[key], ref[key]))

    worst = min(cosines, key=cosines.get)
    fig = dict(loss=rel("loss"), grad_norm=rel("grad_norm"),
               cos=cosines[worst], worst=worst)
    ok = (fig["loss"] <= limits["loss"]
          and fig["grad_norm"] <= limits["grad_norm"]
          and fig["cos"] >= limits["cos"])
    return ok, fig


# --- (j) ---------------------------------------------------------------------
# the launchers through the entry points a user calls, with the CLI's own
# requests (prompts of 5-15 tokens, max_len 96, four slots, chunks of 8) at
# 32 new tokens each; the gateway one token in four a tick, so that its
# crash lands mid-run
LAUNCH_SERVE = ["--arch", "qwen3-14b", "--paged", "--page-storage", "fp8",
                "--attn-impl", "pallas", "--requests", "6", "--max-new",
                "32"]
LAUNCH_GATEWAY = LAUNCH_SERVE + ["--gateway", "2", "--chaos", "6=crash:0",
                                 "--chunk", "4"]
LAUNCH_DSV3 = ["--arch", "deepseek-v3-671b", "--paged", "--mtp",
               "--attn-impl", "pallas", "--fp8-impl", "pallas",
               "--requests", "6", "--max-new", "32"]
LAUNCH_TRAIN = ["--arch", "qwen1.5-4b", "--steps", "4", "--batch", "4",
                "--seq", "64"]


def cli(torch, label, fn, *args):
    """One launcher call, its launch counters zeroed just before and read
    just after, its printed lines logged under ``label``. Returns (result,
    lines, launch counts, wall s)."""
    import io
    from repro_torch.kernels import registry
    gc_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[{label}] | {line}")
    log(f"[{label}] wall {wall:.2f} s (weights drawn on the card included); "
        f"launches {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return res, lines, counts, wall


def launch_gate(label, counts, kernels, eng=None, reqs=(), max_new=32):
    """Each of ``kernels`` launched; every request done with ``max_new``
    in-vocabulary tokens; one decode capture; no page leaked."""
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        raise AssertionError(f"[{label}] never launched {missing}")
    for r in reqs:
        if not r.done or len(r.out) != max_new or min(r.out) < 0 or \
                max(r.out) >= eng.cfg.vocab_size:
            raise AssertionError(f"[{label}] request {r.rid}: done={r.done}, "
                                 f"{len(r.out)} tokens (want {max_new})")
    if eng is not None:
        if eng.trace_counts["decode"] != 1:
            raise AssertionError(f"[{label}] trace_counts "
                                 f"{eng.trace_counts}, want one decode "
                                 "capture")
        if eng.paged and eng.free_pages() != eng.pool_pages:
            raise AssertionError(f"[{label}] pages leaked")


def decode_step_ms(eng):
    """Graphed ms a decode step of the CLI's engine at four slots: four of
    the CLI's prompts admitted in one tick, then each later tick (one
    replay of the chunk's graph and its host read) timed until the first
    request finishes."""
    import numpy as np
    from repro_torch.launch.serve import prompts
    from repro_torch.serve.engine import Request
    reqs = [Request(100 + i, p, max_new=64)
            for i, p in enumerate(prompts(eng.cfg, eng.slots))]
    for r in reqs:
        eng.submit(r)
    eng.step()
    ticks = []
    while not any(r.done for r in reqs):
        t0 = time.perf_counter()
        eng.step()
        ticks.append(time.perf_counter() - t0)
    eng.run_until_done()
    return 1e3 * float(np.median(ticks)) / eng.chunk, len(ticks)


@contextlib.contextmanager
def step_times(trainer_cls):
    """Each training step's wall time, from its start to the host's read
    of its loss (the trainer's own step observation, which reads it)."""
    times, observe = [], trainer_cls._observe_step

    def timed(self, metrics, t0):
        observe(self, metrics, t0)
        times.append(time.perf_counter() - t0)
    trainer_cls._observe_step = timed
    try:
        yield times
    finally:
        trainer_cls._observe_step = observe


def phase_launchers(torch):
    """(j): ``repro_torch.launch.serve`` and ``launch.train`` on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.api import count_params
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    res, _, counts, _ = cli(torch, "j.1", serve.main, LAUNCH_SERVE)
    eng = res["engine"]
    launch_gate("j.1", counts, ("flash_prefill", "paged_gqa_decode"), eng,
                res["requests"])
    ms, n = decode_step_ms(eng)
    log(f"[j.1] graphed decode at 4 slots: {ms:.3f} ms a step (median of "
        f"{n} ticks of {eng.chunk} steps, host read included)")
    del res, eng
    log(f"[time] (j.1) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    res, _, counts, _ = cli(torch, "j.2", serve.main, LAUNCH_GATEWAY)
    s = res["stats"]
    launch_gate("j.2", counts, ("flash_prefill", "paged_gqa_decode"))
    if s["completed"] != s["submitted"] or not all(
            g.done and len(g.delivered) == 32 for g in res["requests"]):
        raise AssertionError(f"[j.2] gateway {s}")
    if s["replica_deaths"] != 1:
        raise AssertionError(f"[j.2] the crash did not land: {s}")
    del res
    log(f"[time] (j.2) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    spec = PATHS["deepseek-v3-671b"]
    cfg = get_config(spec["model"], **spec["overrides"])
    args = serve.parser().parse_args(LAUNCH_DSV3)
    res, lines, counts, _ = cli(torch, "j.3", serve.run, cfg, args)
    eng = res["engine"]
    launch_gate("j.3", counts, ("fp8_gemm", "moe_gemm", "paged_mla_decode"),
                eng, res["requests"])
    if eng.stats["drafts"] <= 0 or not any(
            x.startswith("[serve] MTP speedup model") for x in lines):
        raise AssertionError("[j.3] no MTP draft, or no acceptance line")
    del res, eng
    log(f"[time] (j.3) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with step_times(Trainer) as times:
        out, _, counts, _ = cli(torch, "j.4", train.main, LAUNCH_TRAIN)
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != 4 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[j.4] losses {losses}")
    n = count_params(get_config("qwen1.5-4b"))
    log(f"[j.4] losses {[round(v, 4) for v in losses]}; ms a step "
        f"{[round(1e3 * t, 2) for t in times]} (4 x 64 tokens); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB against the state "
        f"reckoned at 12 B a parameter: {12 * n / 1e9:.2f} GB ({n} "
        "parameters)")
    log(f"[time] (j.4) {time.perf_counter() - t0:.1f} s")


def get_vocab(model):
    from repro_torch.configs.base import get_config
    return get_config(model).vocab_size


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, registry
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    clock = [t_start]

    def lap(what):
        now = time.perf_counter()
        log(f"[time] {what}: {now - clock[0]:.1f} s")
        clock[0] = now

    card = phase_env(torch, build)
    lap("(a) environment and build")
    kernels = phase_kernels(torch)
    lap("(b) kernels")
    launches = {}
    for path, spec in PATHS.items():
        counts = (phase_recurrent_path if spec.get("recurrent")
                  else phase_memory_path if "memory" in spec
                  else phase_main_path)(torch, path)
        for k in spec["kernels"]:        # each kernel: the first path of it
            launches.setdefault(k, counts[k])
        lap(f"(c) path {path}")
    for name, engine, *overrides in REFERENCE_CHECKS:
        phase_reference(torch, name, engine, *overrides)
    lap("(d) reference checks")
    ring = phase_ring(torch, card, kernels)
    for k in ("logfmt_encode", "logfmt_decode"):
        launches[k] = ring[k]            # per rank, one 8-bit call
    lap("(e) compressed ring")
    gc_cuda(torch)
    log(f"[g] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before "
        "training")
    backward = bench_fp8_train(torch, torch.device("cuda"),
                               torch.Generator(device="cuda").manual_seed(7))
    back_launches, _, losses = phase_train(torch)
    phase_train_curves(torch, losses)
    phase_train_reference(torch)
    lap("(g) training")
    phase_mesh(torch, card)
    lap("(h) mesh serving")
    gc_cuda(torch)
    mesh_fp8 = phase_train_mesh(torch, card)
    lap("(i) meshed training")
    gc_cuda(torch)
    phase_launchers(torch)
    lap("(j) launchers")

    # one entry per kernel: the main path's shape (decode-time where the
    # kernel runs at decode; E4M3 codes and w1/w3 for moe_gemm, the fp8
    # pool for paged_gqa_decode, the bf16 rings for mla_decode, 8 bits for
    # the LogFMT pair, whose launches are those of one rank's 8-bit
    # compressed_psum call)
    pick = {"fp8_gemm": 1, "moe_gemm": 0, "paged_mla_decode": 0,
            "paged_gqa_decode": 0, "flash_prefill": 0, "mla_decode": 0,
            "logfmt_encode": 0, "logfmt_decode": 0}
    table = []
    for name, rows in kernels.items():
        r = rows[pick[name]]
        op = registry.get(name)
        table.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=op.replaces.split()[0], launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in rows), ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"]))
    # fp8_gemm's backward products in training (g.1), at the FFN's
    # w_gate/w_up as its forward row; launches: the backward's, over
    # phase (g.2)'s run (dx and dw alike)
    op = registry.get("fp8_gemm")
    for r in backward:
        if r["weight"] != "w_gate/w_up" or r["kind"] == "fwd":
            continue
        table.append(dict(
            name="fp8_gemm", route="cuda",
            source="src/repro_torch/csrc/fp8_gemm.cu",
            replaces=op.replaces.split()[0], launches=back_launches // 2,
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=f"training backward, {r['shape']}"))
    log(f"[i] fp8_gemm launches a rank and meshed train step: {mesh_fp8}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
