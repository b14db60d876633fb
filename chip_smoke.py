#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

from the root of a checkout. Phases, each fatal on failure:

  (a) environment: the card's name and power limit (nvidia-smi), the
      torch/CUDA versions; build every kernel under src/repro_torch/csrc
      with nvcc (one process per source, in parallel) and time the build;
  (b) kernels: each hand-written kernel against its plain PyTorch version
      on the card, at the shapes the main path gives it, with the stated
      tolerance; per kernel the kernel time, the plain version's time, the
      bound (least time for the bytes it must move or the operations it
      must do, at the H100's published peaks) and, where one PyTorch call
      computes the same function, that call's time (``library_ms``);
  (c) the main path: DeepSeek-V3 at published widths, depth cut 61 -> 4
      (three dense layers, one MoE layer), seeded random weights, served
      by ``ServeEngine(paged=True, page_storage="fp8", attn_impl="pallas")``
      with ``fp8_impl="pallas"``: six seeded prompts of 16-600 tokens, 32
      new tokens each, greedy. Every request must finish with the right
      count of in-vocabulary tokens, and each kernel's launch counter
      (zeroed just before) must have moved;
  (d) a reference check on a small input: the same engine at smoke width
      (bf16) on the card, through the kernels, against the plain versions
      on the CPU, same weights.

The line before the last two is one JSON object with the kernel table; the
next is the nvidia-smi name and power limit; the last is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits non-zero before printing any result.
"""
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp8": 1979e12, "bf16": 989e12, "fp32": 67e12}


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
            if "registers" in line or "spill" in line:
                log(f"[a]   {name}: {line.strip()}")
    return card


# --- (b) ---------------------------------------------------------------------


def check(name, err_rel, tol):
    if not (err_rel <= tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max error {err_rel:.3g} of max|plain| "
                             f"> tolerance {tol:.3g}")


def bench_fp8_gemm(torch, dev, gen):
    from repro_torch.core import fp8
    from repro_torch.kernels.fp8_gemm import ops
    tol = 2e-5    # fp32 sums of exact products in another order
    rows = []
    for M in (4, 512):
        for K, N, what in ((16384, 7168, "w_o"), (7168, 18432, "mlp")):
            x = torch.randn(M, K, generator=gen, device=dev)
            w = torch.randn(K, N, generator=gen, device=dev) * 0.02
            xq, xs = fp8.quantize_tilewise(x)
            wq, ws = fp8.quantize_blockwise(w)
            y = ops.fp8_gemm(xq, xs, wq, ws)
            ref = ops.fp8_gemm.run_plain(xq, xs, wq, ws)
            err, rel = max_err(torch, y, ref)
            check(f"fp8_gemm {M}x{K}x{N}", rel, tol)
            ms = cuda_ms(torch, lambda: ops.fp8_gemm(xq, xs, wq, ws), 20)
            plain = cuda_ms(torch, lambda: ops.fp8_gemm.run_plain(
                xq, xs, wq, ws), 5)
            nbytes = M * K + M * (K // 128) * 4 + K * N + ws.numel() * 4 \
                + M * N * 4
            b, by = bound_ms(nbytes, 2 * M * N * K, "fp8")
            lib = scaled_mm_ms(torch, xq, xs, wq, ws, ref)
            rows.append(dict(shape=f"M={M} K={K} N={N} ({what})",
                             max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
                             plain_ms=plain, bound_ms=b, bound_by=by,
                             library_ms=lib))
            del x, w, xq, xs, wq, ws, y, ref
    return rows


def scaled_mm_ms(torch, xq, xs, wq, ws, ref):
    """torch._scaled_mm with 1x128 / 128x128 block scales, where the
    installed torch offers it and it computes the same function; else
    None (reported as null). A yardstick only: the port never calls it."""
    fn = getattr(torch, "_scaled_mm", None)
    if fn is None:
        log("[b]   library: torch._scaled_mm absent")
        return None
    b = wq.t().contiguous().t()                    # column-major operand
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


def bench_moe_gemm(torch, dev, gen):
    from repro_torch.kernels.moe_gemm import ops
    tol = 2 ** -7   # bf16 output: one rounding step of the largest value
    rows = []
    for D, F, what in ((7168, 2048, "w1/w3"), (2048, 7168, "w2")):
        E, C = 256, 8
        x = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
        w = (torch.randn(E, D, F, generator=gen, device=dev) * 0.02).bfloat16()
        y = ops.grouped_matmul(x, w)
        ref = ops.grouped_matmul.run_plain(x, w)
        err, rel = max_err(torch, y, ref)
        check(f"moe_gemm {what}", rel, tol)
        ms = cuda_ms(torch, lambda: ops.grouped_matmul(x, w), 10)
        plain = cuda_ms(torch, lambda: ops.grouped_matmul.run_plain(x, w), 2,
                        warmup=1)
        lib = cuda_ms(torch, lambda: torch.bmm(x, w), 10)
        nbytes = 2 * (E * C * D + E * D * F + E * C * F)
        b, by = bound_ms(nbytes, 2 * E * C * D * F, "bf16")
        rows.append(dict(shape=f"E={E} C={C} D={D} F={F} ({what})",
                         max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
                         plain_ms=plain, bound_ms=b, bound_by=by,
                         library_ms=lib))
        del x, w, y, ref
        torch.cuda.empty_cache()
    return rows


def bench_paged_mla(torch, dev, gen):
    from repro_torch.core import paged
    from repro_torch.kernels.paged_attention import ops
    tol = 2e-5    # fp32 online vs full softmax, same exact dequantization
    B, H, R, Rr, page, pp = 4, 128, 512, 64, 8, 128
    P = B * pp
    qa = torch.randn(B, H, R, generator=gen, device=dev)
    qr = torch.randn(B, H, Rr, generator=gen, device=dev)
    ckv, cs = paged.quantize_vecs(torch.randn(P + 1, page, R, generator=gen,
                                              device=dev))
    kr, ks = paged.quantize_vecs(torch.randn(P + 1, page, Rr, generator=gen,
                                             device=dev))
    ckv, kr = ckv.view(torch.uint8), kr.view(torch.uint8)
    table = torch.randperm(P, generator=gen, device=dev).reshape(B, pp).int()
    ctx = [64, 300, 700, 1024]                   # contexts of the 4 slots
    qpos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(192)
    args = (qa, qr, ckv, kr, cs, ks, table, qpos)
    y = ops.paged_mla_decode(*args, scale=scale)
    ref = ops.paged_mla_decode.run_plain(*args, scale=scale)
    err, rel = max_err(torch, y, ref)
    check("paged_mla_decode", rel, tol)
    ms = cuda_ms(torch, lambda: ops.paged_mla_decode(*args, scale=scale), 50)
    plain = cuda_ms(torch, lambda: ops.paged_mla_decode.run_plain(
        *args, scale=scale), 5)
    tokens = sum(ctx)
    nbytes = (tokens * (R + Rr + 8) + 4 * B * H * (R + Rr) + 4 * B * pp
              + 4 * B + 4 * B * H * R)
    flops = tokens * H * (2 * (R + Rr) + 2 * R)
    b, by = bound_ms(nbytes, flops, "fp32")
    return [dict(shape=f"B={B} H={H} R={R} Rr={Rr} page={page} "
                 f"contexts={ctx} (fp8 pool)",
                 max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
                 plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)]


def phase_kernels(torch):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"fp8_gemm": bench_fp8_gemm(torch, dev, gen),
           "moe_gemm": bench_moe_gemm(torch, dev, gen),
           "paged_mla_decode": bench_paged_mla(torch, dev, gen)}
    for name, rows in out.items():
        for r in rows:
            lib = ("null" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            log(f"[b] {name} {r['shape']}: max_abs_err {r['max_abs_err']:.3g}"
                f" (rel {r['rel_err']:.3g} <= tol {r['tol']:.3g}); kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} ms")
    torch.cuda.empty_cache()
    return out


# --- (c) ---------------------------------------------------------------------


def phase_main_path(torch):
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import registry
    from repro_torch.serve.engine import Request, ServeEngine

    full = get_config("deepseek-v3-671b")
    cfg = get_config("deepseek-v3-671b", num_layers=4, fp8_impl="pallas")
    log(f"[c] config: {cfg.name} at published widths (d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}); depth cut "
        f"{full.num_layers} -> {cfg.num_layers} ({cfg.moe.layout}: 3 dense + "
        f"1 MoE); fp8_impl={cfg.fp8_impl}; seeded random weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, slots=4, max_len=1024, paged=True,
                      page_storage="fp8", attn_impl="pallas", device="cuda",
                      seed=0)
    torch.cuda.synchronize()
    log(f"[c] engine up (weights drawn on the card, expert qdq + fp8 weight "
        f"quantization at load): {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    rng = np.random.default_rng(0)
    lengths = [16, 120, 250, 380, 490, 600]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, L).astype(np.int32),
                    max_new=32) for i, L in enumerate(lengths)]
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    ttft = {}
    ticks = 0
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
    log(f"[c] launches on the main path: {counts}")
    for r in reqs:
        if not r.done or len(r.out) != 32:
            raise AssertionError(f"request {r.rid}: done={r.done}, "
                                 f"{len(r.out)} tokens (want 32)")
        if min(r.out) < 0 or max(r.out) >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: token out of vocabulary")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    if eng.free_pages() != eng.pool_pages:
        raise AssertionError("pages leaked after every request finished")
    ntok = sum(len(r.out) for r in reqs)
    log(f"[c] {len(reqs)} requests, prompts {lengths}, {ntok} tokens in "
        f"{wall:.3f} s over {ticks} ticks ({ntok / wall:.1f} tok/s end to "
        f"end); TTFT (at tick granularity) s: "
        f"{[round(ttft[r.rid], 3) for r in reqs]}")
    log(f"[c] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # steady-state decode: four active slots, one fused chunk, timed alone
    model, params, cache = eng.model, eng.params, eng.cache
    st = model.init_decode_state(4)
    st["active"][:] = True
    st["positions"][:] = torch.tensor([600, 700, 800, 900], device="cuda",
                                      dtype=torch.int32)
    st["left"][:] = 1 << 20
    model.decode_loop(params, cache, st, 1)             # warm
    registry.reset_launch_counts()
    model.decode_loop(params, cache, st, 1)
    per_step = registry.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _, _, _ = model.decode_loop(params, cache, st, 8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[c] launches per decode step: {per_step}")
    log(f"[c] steady decode, 4 slots x 8 steps: {1e3 * dt / 8:.2f} ms/step, "
        f"{32 / dt:.1f} tok/s")
    profile_decode(torch, model, params, cache, st)

    # prefill alone: the longest prompt, bucket 1024
    p = reqs[-1].prompt
    toks = np.zeros((1, 1024), np.int32)
    toks[0, :len(p)] = p
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, {"tokens": torch.as_tensor(toks)},
                  lengths=[len(p)])
    torch.cuda.synchronize()
    log(f"[c] prefill of a {len(p)}-token prompt (bucket 1024): "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")

    # the output itself: finite logits of the right shape
    logits, _ = model.prefill(params, {"tokens": torch.as_tensor(
        reqs[0].prompt[None])})
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("main-path logits are not finite (1,1,V)")
    del eng, model, params, cache
    torch.cuda.empty_cache()
    return counts


def profile_decode(torch, model, params, cache, st, steps=2):
    """Device time by kernel over ``steps`` decode steps (torch.profiler,
    CUPTI), and the device's busy share of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_loop(params, cache, st, steps)
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
        log("[c] profile: no device time recorded (not measured)")
        return
    rows.sort(reverse=True)
    groups = {}
    for us, n, key in rows:
        g = next((k for k in ("fp8_gemm", "moe_gemm", "paged_mla_decode")
                  if k in key), "other")
        groups[g] = groups.get(g, 0.0) + us
    log(f"[c] profile of {steps} decode steps: device busy {busy / 1e3:.2f} ms"
        f" of {wall_us / 1e3:.2f} ms wall ({100 * busy / wall_us:.1f}% busy "
        f"under the profiler); per step by kernel: " + ", ".join(
            f"{g} {v / 1e3 / steps:.3f} ms ({100 * v / busy:.1f}%)"
            for g, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for us, n, key in rows[:14]:
        log(f"[c]   {us / 1e3 / steps:8.3f} ms/step  x{n // steps:<4d} "
            f"{key[:90]}")


# --- (d) ---------------------------------------------------------------------


def phase_reference(torch):
    import dataclasses

    import numpy as np
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.api import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(
        smoke_config(get_config("deepseek-v3-671b")), dtype="bfloat16",
        param_dtype="bfloat16", fp8_impl="pallas")
    params = Model(cfg, device="cpu").init(seed=1)
    prompts = [np.arange(5 + 7 * i) * (i + 3) % cfg.vocab_size
               for i in range(3)]
    outs, logits = {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(cfg, params=params, slots=2, max_len=64,
                          paged=True, page_storage="fp8", attn_impl="pallas",
                          chunk=4, device=dev)
        reqs = [Request(i, p, max_new=8) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        outs[dev] = [r.out for r in reqs]
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(prompts[2])] = prompts[2]
        lg, _ = eng.model.prefill(eng.params, {"tokens": torch.as_tensor(toks)},
                                  lengths=[len(prompts[2])])
        logits[dev] = lg.float().cpu()
    a, b = logits["cuda"], logits["cpu"]
    rel = float((a - b).abs().max() / b.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(a.flatten(),
                                                      b.flatten(), dim=0))
    same = sum(x == y for o1, o2 in zip(outs["cuda"], outs["cpu"])
               for x, y in zip(o1, o2))
    log(f"[d] smoke width, bf16: first-token logits card vs CPU plain: max "
        f"err {rel:.3g} of max|logit| (tol 5e-2), cosine {cos:.6f} (>= "
        f"0.999); greedy tokens equal {same}/24")
    if not (rel <= 5e-2 and cos >= 0.999):
        raise AssertionError("kernel path disagrees with the plain path on "
                             "the small input")


# --- main ----------------------------------------------------------------------


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, registry
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = phase_env(torch, build)
    kernels = phase_kernels(torch)
    counts = phase_main_path(torch)
    phase_reference(torch)

    # one entry per kernel: the decode-time shape of the main path
    pick = {"fp8_gemm": 1, "moe_gemm": 0, "paged_mla_decode": 0}
    table = []
    for name, rows in kernels.items():
        r = rows[pick[name]]
        op = registry.get(name)
        table.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=op.replaces.split()[0], launches=counts[name],
            max_abs_err=max(x["max_abs_err"] for x in rows), ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
