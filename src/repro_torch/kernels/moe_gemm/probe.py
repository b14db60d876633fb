"""What holds ``moe_gemm``'s bf16 weight format back: a timing probe.

Runs on the machine with the card, from the root of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.moe_gemm.probe

At the main path's shapes it times, in one process and in interleaved
rounds (CUDA events, 10 launches after 2 warm-ups):

* ``bf16 strided``: the bf16 format on the caller's ``(E, D, F)`` weights,
  as ``grouped_matmul`` runs it. A stage is two 64 x 64 TMA boxes over 64
  rows of 128 B, ``2F`` bytes apart.
* ``bf16 tile-contiguous``: the same kernel on the same values laid out
  ``(E * F/128, D, 128)`` (each F tile's weights contiguous, so a stage is
  one 16 KB run), with x repeated per F tile. Only the layout changes; the
  result is checked bit for bit against the strided run.
* each of those again in a build with one CTA per SM (``1cta``: the ring
  goes from 6 to 8 stages at C = 8, the consumer warps from 16 to 8);
* the E4M3 format (the main path's), and ``torch.bmm`` on the bf16
  weights;
* at C = 8, the bf16 format through ``grouped_matmul`` and directly, the
  E4M3 format and ``torch.bmm``, with nothing before them and then each
  right after the E4M3 plain version, as ``chip_smoke.py`` phase (b)
  times them.

With ``--first DIR``, DIR holds the first version's ``moe_gemm.cu`` (and
its ``mma.cuh``), from a ``git archive`` of an earlier commit; it is built
beside the others and timed at every shape and state as ``bf16 first
version`` (its C entry takes x padded to 16 rows).

Each row prints ms, the bytes the launch must read and write, and the
rate. Variants are built from ``csrc/moe_gemm.cu`` by a text substitution
into ``build/probe/``. Nothing runs at import time.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess

from pathlib import Path

import torch

from repro_torch.core import fp8
from repro_torch.kernels import build

ONE_CTA = ("static constexpr int CTAS = NT <= 5 ? 2 : 1;",
           "static constexpr int CTAS = 1;")


def _build_variants(first=None):
    """The kernel and its one-CTA variant (C entries of the current
    signature), and with ``first`` the first version (x, w, y, E, C, D, F,
    stream), built in parallel."""
    src = (build.CSRC / "moe_gemm.cu").read_text()
    assert ONE_CTA[0] in src, "the source no longer has the CTA rule"
    out = build.BUILD.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"base": (src, build.CSRC),
               "1cta": (src.replace(*ONE_CTA), build.CSRC)}
    if first is not None:
        sources["first"] = ((Path(first) / "moe_gemm.cu").read_text(),
                            Path(first))
    procs = {}
    for name, (text, inc) in sources.items():
        (out / f"moe_gemm_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(inc), "-o",
             str(out / f"moe_gemm_{name}.so"),
             str(out / f"moe_gemm_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    v, i = ctypes.c_void_p, ctypes.c_int
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        f = ctypes.CDLL(str(out / f"moe_gemm_{name}.so")).moe_gemm
        f.argtypes = ([v, v, v, i, i, i, i, v] if name == "first"
                      else [v, v, v, v, i, i, i, i, i, v])
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def _ms(fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _context(x, w, codes, direct, first, label):
    """chip_smoke.py times each format right after its plain version (an
    fp32 einsum over the dequantized weights). Time the bf16 format through
    ``grouped_matmul`` and directly, the E4M3 format and torch.bmm, first
    with nothing before them, then each right after that plain version."""
    from repro_torch.kernels.moe_gemm import ops
    rows = {"bf16 via grouped_matmul": lambda: ops.grouped_matmul(x, w),
            "bf16 direct": direct,
            "e4m3 via grouped_matmul": lambda: ops.grouped_matmul(x, codes),
            "torch.bmm": lambda: torch.bmm(x, w)}
    if first is not None:
        rows["bf16 first version"] = first
    for when in ("clean", "after the plain version"):
        for key, fn in rows.items():
            if when != "clean":
                ops.grouped_matmul.run_plain(x, codes)
                torch.cuda.empty_cache()
            print(f"{label} {when}: {key}: {_ms(fn):.4f} ms", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", help="directory holding the first version's "
                    "moe_gemm.cu and mma.cuh")
    args = ap.parse_args(argv)
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(name.strip(), flush=True)
    fns = _build_variants(args.first)
    first = fns.pop("first", None)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for E, D, F, Cs in ((256, 7168, 2048, (8, 40)), (256, 2048, 7168, (8,))):
        FT = F // 128
        w = (torch.randn(E, D, F, generator=g, device=dev) * 0.02).bfloat16()
        wt = w.view(E, D, FT, 128).transpose(1, 2).contiguous()
        codes = fp8.Fp8Experts.quantize(w)
        for C in Cs:
            x = torch.randn(E, C, D, generator=g, device=dev).bfloat16()
            xt = x.repeat_interleave(FT, 0)
            y = torch.empty(E, C, F, dtype=torch.bfloat16, device=dev)
            yt = torch.empty(E * FT, C, 128, dtype=torch.bfloat16, device=dev)
            out_b = 2 * E * C * F
            rows = {}
            for var, f in fns.items():
                rows[f"bf16 strided {var}"] = (
                    lambda f=f: f(_ptr(x), _ptr(w), None, _ptr(y), E, C, D,
                                  F, 0, stream),
                    2 * (E * D * F + E * C * D) + out_b)
                rows[f"bf16 tile-contiguous {var}"] = (
                    lambda f=f: f(_ptr(xt), _ptr(wt), None, _ptr(yt),
                                  E * FT, C, D, 128, 0, stream),
                    2 * (E * D * F + E * FT * C * D) + out_b)
            rows["e4m3 base"] = (
                lambda: fns["base"](_ptr(x), _ptr(codes.wq), _ptr(codes.ws),
                                    _ptr(y), E, C, D, F, 1, stream),
                codes.nbytes + 2 * E * C * D + out_b)
            rows["torch.bmm"] = (lambda: torch.bmm(x, w),
                                 2 * (E * D * F + E * C * D) + out_b)
            if first is not None:
                x16 = torch.zeros(E, -(-C // 16) * 16, D, dtype=x.dtype,
                                  device=dev)
                x16[:, :C] = x
                y16 = torch.empty(E, x16.shape[1], F, dtype=x.dtype,
                                  device=dev)
                rows["bf16 first version"] = (
                    lambda: first(_ptr(x16), _ptr(w), _ptr(y16), E,
                                  x16.shape[1], D, F, stream),
                    2 * (E * D * F + E * C * D) + out_b)
            for key, (fn, _) in rows.items():
                if key != "torch.bmm" and fn() != 0:
                    raise RuntimeError(f"{key}: launch failed")
                torch.cuda.synchronize()
            # same values, two layouts: the kernel must give the same bits
            rows["bf16 strided base"][0]()
            rows["bf16 tile-contiguous base"][0]()
            same = torch.equal(
                y, yt.view(E, FT, C, 128).transpose(1, 2).reshape(E, C, F))
            print(f"E={E} C={C} D={D} F={F}: tile-contiguous == strided "
                  f"bitwise: {same}", flush=True)
            if not same:
                raise RuntimeError("the two layouts disagree")
            keys = list(rows)
            for rnd in range(3):
                for key in keys if rnd % 2 == 0 else keys[::-1]:
                    fn, nbytes = rows[key]
                    t = _ms(fn)
                    print(f"round {rnd} E={E} C={C} D={D} F={F} {key}: "
                          f"{t:.4f} ms, {nbytes / 1e9:.4f} GB, "
                          f"{nbytes / t / 1e9:.3f} TB/s", flush=True)
            if first is not None:      # the same function, within 2^-7
                rows["bf16 strided base"][0]()
                rows["bf16 first version"][0]()
                err = (y16[:, :C].float() - y.float()).abs().max()
                if err > y.float().abs().max() * 2 ** -7:
                    raise RuntimeError("the first version disagrees")
            if C == 8:
                _context(x, w, codes, rows["bf16 strided base"][0],
                         rows.get("bf16 first version", (None,))[0],
                         f"E={E} C={C} D={D} F={F}")
            del x, xt, y, yt, rows
        del w, wt, codes
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
