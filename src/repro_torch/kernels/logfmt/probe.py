"""Where ``logfmt_encode``'s time goes: a timing probe of build variants.

Runs on the machine with the card, from the root of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.logfmt.probe [--parent PATH]

At the compressed ring's hop chunk ((1792, 18432) fp32, a quarter of a
DeepSeek-V3 ``w1`` gradient at 4 ranks) at 8 and 10 bits, it times each
build below in a CUDA graph of 20 calls replayed 10 times under CUDA
events, in two rounds (the second in reverse order), beside the byte bound
(x read once, codes and sideband written once, at 3.35 TB/s):

* ``kernel``: ``csrc/logfmt_encode.cu`` as the op builds it;
* ``stream-only``: the same loads and stores with the arithmetic cut out
  (codes from the bits, no range): what the card takes for these bytes;
* one build per lever the design keeps, with that lever taken back:
  ``logs-for-range`` (a logf of every value and shuffles for each tile's
  min and max, in place of two integer reductions and two logf),
  ``checked-everywhere`` (every value's level from the reference's
  comparison of the two grid points around u's nearest integer, no error
  bound), ``reference-arithmetic`` (every tile on the reference's
  per-value path: logf, division, two expf), ``one-tile-a-warp`` and
  ``four-tiles-a-warp`` (fewer tiles loaded at once, and each tile's
  parameters worked out by fewer lanes side by side);
* ``unchecked-estimate``: floor(u) for every value, with no check: its
  share of codes that differ is what the check repairs;
* ``parent``, with ``--parent``: another source of the same C entry (the
  kernel of an earlier commit, from a ``git archive``), built the same way.

After every timing (an fp32 plain version slows what follows it), each
build's share of codes that differ from the plain version's is printed
(``stream-only``'s are wrong and are not checked), and the card's name
and power limit.

Variants are built from ``csrc/logfmt_encode.cu`` by a text substitution
into ``build/probe/logfmt_encode/``, one ``nvcc`` each, all started
together. Nothing runs at import time.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.core.logfmt import TILE
from repro_torch.kernels import build, registry
from repro_torch.kernels.logfmt import ops
from repro_torch.launch.costs import HBM_BW

N, D = 1792, 18432
BITS = (8, 10)

_RANGES = "    tile_ranges(v, lane, mn_j, mx_j);\n"
_ENCODE = "      encode(v[j], q, r, levels, c);\n"
_PARAMS = "// the parameters of a tile from its min and max of the logs"
_BOUND = "  p.half_minus_e = 0.5f - e;"
_LOGS_RANGES = """\
__device__ __forceinline__ void tile_ranges_logs(
    const float (&v)[TILES_PER_WARP][4], int lane, float& mn, float& mx) {
  mn = mx = 0.f;
#pragma unroll
  for (int j = 0; j < TILES_PER_WARP; ++j) {
    float lmin = INFINITY, lmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned b = nonzero_bits(v[j][i]);
      if (b) {
        const float la = logf(__uint_as_float(b));
        lmin = fminf(lmin, la);
        lmax = fmaxf(lmax, la);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lmin = fminf(lmin, __shfl_xor_sync(FULL, lmin, o));
      lmax = fmaxf(lmax, __shfl_xor_sync(FULL, lmax, o));
    }
    if (lane == j && lmax > -INFINITY) {
      mn = lmin;
      mx = lmax;
    }
  }
}

"""

# (name, [(text of csrc/logfmt_encode.cu, its replacement)])
VARIANTS = {
    "stream-only": [
        (_RANGES, "    mn_j = mx_j = 0.f;\n"),
        (_ENCODE, "      for (int i = 0; i < 4; ++i) "
                  "c[i] = __float_as_uint(v[j][i]) >> 24;\n")],
    "logs-for-range": [
        (_RANGES, "    tile_ranges_logs(v, lane, mn_j, mx_j);\n"),
        (_PARAMS, _LOGS_RANGES + _PARAMS)],
    "checked-everywhere": [(_BOUND, "  p.half_minus_e = -1.f;")],
    "reference-arithmetic": [
        ("constexpr float FAST_MIN_STEP = 1.0f / 8192.0f;",
         "constexpr float FAST_MIN_STEP = 3.0e38f;")],
    "one-tile-a-warp": [("constexpr int TILES_PER_WARP = 4;",
                         "constexpr int TILES_PER_WARP = 1;")],
    "eight-tiles-a-warp": [("constexpr int TILES_PER_WARP = 4;",
                            "constexpr int TILES_PER_WARP = 8;")],
    "unchecked-estimate": [(_BOUND, "  p.half_minus_e = 0.5f;")],
}


def _build(sources):
    """Compile {name: source text} into libraries, in parallel; returns
    {name: (CDLL, its registers and spills as ptxas reports them)}."""
    out = build.BUILD.parent / "probe" / "logfmt_encode"
    procs = {}
    for name, text in sources.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        src = d / "logfmt_encode.cu"
        src.write_text(text)
        lib = d / "liblogfmt.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        regs = (f"registers {re.findall(r'Used (\d+) registers', text)}, "
                f"spill bytes {re.findall(r'(\d+) bytes spill', text)}")
        libs[name] = (ctypes.CDLL(str(lib)), regs)
    return libs


def _sources(parent):
    base = (build.CSRC / "logfmt_encode.cu").read_text()
    srcs = {"kernel": base}
    for name, cuts in VARIANTS.items():
        text = base
        for old, new in cuts:
            assert text.count(old) == 1, f"{name}: the kernel changed"
            text = text.replace(old, new)
        srcs[name] = text
    if parent:
        srcs["parent"] = Path(parent).read_text()
    return srcs


def _graph_ms(call, n=20, reps=10):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            call()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another logfmt_encode.cu to time")
    args = ap.parse_args()
    libs = _build(_sources(args.parent))
    for name, (_, regs) in libs.items():
        print(f"{name}: {regs}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(N, D, generator=gen, device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; x ({N}, {D}) fp32", flush=True)
    outs = {}
    for n_bits in BITS:
        codes = torch.empty(N, D, dtype=torch.uint8 if n_bits <= 8
                            else torch.uint16, device=dev)
        mn = torch.empty(N, D // TILE, device=dev)
        step = torch.empty_like(mn)
        nbytes = N * D * (4 + codes.element_size()) + 8 * N * D // TILE
        bound = 1e3 * nbytes / HBM_BW
        order = list(libs)
        times = {name: [] for name in order}
        for names in (order, order[::-1]):
            for name in names:
                fn = libs[name][0].logfmt_encode
                fn.argtypes = ops._entry("logfmt_encode").argtypes
                fn.restype = ctypes.c_int
                ptrs = [registry.ptr(t) for t in (x, codes, mn, step)]

                def call(fn=fn, ptrs=ptrs, name=name):
                    err = fn(*ptrs, N * D // TILE, n_bits, 0,
                             registry.stream_ptr(codes))
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                times[name].append(_graph_ms(call))
                if len(times[name]) == 1:
                    outs[(name, n_bits)] = codes.clone()
        for name in order:
            ms = times[name]
            print(f"{n_bits} bits, {name}: {ms[0]:.4f} / {ms[1]:.4f} ms in a "
                  f"graph (rounds 1 / 2); bound {bound:.4f} ms ({nbytes / 1e6:.1f}"
                  f" MB), {100 * bound / min(ms):.1f}% of it, "
                  f"{nbytes / (min(ms) * 1e9):.3f} TB/s", flush=True)
    for n_bits in BITS:
        rc = ops.logfmt_encode.run_plain(x, n_bits=n_bits)[0]
        for name in libs:
            if name == "stream-only":
                continue
            off = float((outs[(name, n_bits)] != rc).float().mean())
            print(f"{n_bits} bits, {name}: {off:.3g} of the codes differ from "
                  "the plain version's", flush=True)


if __name__ == "__main__":
    main()
