"""Where ``mla_decode``'s time goes, and which split size serves it best: a
timing probe.

Runs on the machine with the card, from the root of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.mla_attention.probe

At DeepSeek-V3's decode shape (four slots, 128 heads, R = 512, Rr = 64,
rings of 1024) it times, for full rings (bf16 and fp32) and for the dense
path's served contexts (600, 700, 800 and 900 valid rows, bf16), each in a
CUDA graph of 20 calls replayed 10 times under CUDA events:

* ``rps=32/64/128``: the kernel at each split size (16 heads a CTA, S =
  T / rps splits), its output checked against the op's own call (the plan
  of ``ring_split_plan``) within 2e-5 of its largest value;
* ``no-scores`` and ``no-pv`` at the plan's split size: builds in which
  the score GEMM's loop over the columns, or the P·V loop, is cut out of
  the shared split pass (their outputs are wrong and are not checked):
  what is left of the time is what the other steps cost.

Variants are built from ``csrc/mla_decode.cu`` and its headers by a text
substitution into ``build/probe/mla_decode/``. Nothing runs at import
time.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.mla_attention import ops
from repro_torch.kernels.paged_attention.ops import workspace_floats

# (name, the text of mla_split.cuh it replaces, the replacement)
CUTS = {
    "no-scores": ("for (int c4 = warp; c4 < K4; c4 += WARPS) {",
                  "for (int c4 = warp; c4 < 0; c4 += WARPS) {"),
    "no-pv": ("    // P·V into the register accumulator\n    if (pv) {",
              "    // P·V into the register accumulator\n    if (false) {"),
}
B, H, R, Rr, T = 4, 128, 512, 64, 1024
SERVED = (600, 700, 800, 900)


def _build_cuts():
    """One library per cut, built in parallel; returns name -> CDLL."""
    out = build.BUILD.parent / "probe" / "mla_decode"
    procs = {}
    for name, (old, new) in CUTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in ("mla_decode.cu", "split_kv.cuh"):
            (d / f).write_text((build.CSRC / f).read_text())
        split = (build.CSRC / "mla_split.cuh").read_text()
        assert split.count(old) == 1, f"{name}: the split pass changed"
        (d / "mla_split.cuh").write_text(split.replace(old, new))
        lib = d / "libmla.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(d / "mla_decode.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _entry(lib):
    fn = lib.mla_decode
    fn.argtypes = ops._entry().argtypes
    fn.restype = ctypes.c_int
    return fn


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


def _inputs(gen, dtype, served):
    dev = torch.device("cuda")
    qa = torch.randn(B, H, R, generator=gen, device=dev)
    qr = torch.randn(B, H, Rr, generator=gen, device=dev)
    ckv = torch.randn(B, T, R, generator=gen, device=dev).to(dtype)
    kr = torch.randn(B, T, Rr, generator=gen, device=dev).to(dtype)
    t = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    ctx = torch.tensor(SERVED if served else (T,) * B, dtype=torch.int32,
                       device=dev)
    pos = torch.where(t < ctx[:, None], t, -1).contiguous()
    return qa, qr, ckv, kr, pos, ctx - 1


def main() -> None:
    libs = {"kernel": ops._entry(), **{k: _entry(v)
                                       for k, v in _build_cuts().items()}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 192 ** -0.5
    plan = ops.ring_split_plan(B, H, T, registry.sm_count(
        torch.device("cuda")))
    print(f"{torch.cuda.get_device_name(0)}; ring_split_plan: {plan}")
    for dtype, served in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True)):
        args = _inputs(gen, dtype, served)
        want = ops.mla_decode(*args, scale=scale)
        runs = [("kernel", rps) for rps in (32, 64, 128)]
        runs += [(name, plan[0]) for name in CUTS]
        for name, rps in runs:
            S = -(-T // rps)
            ws = torch.empty(workspace_floats(B, H, S, R),
                             dtype=torch.float32, device="cuda")
            out = torch.empty(B, H, R, dtype=torch.float32, device="cuda")
            ptrs = [registry.ptr(x) for x in (*args, out, ws)]

            def call(fn=libs[name], ptrs=ptrs, S=S, rps=rps):
                err = fn(*ptrs, B, H, R, Rr, T, rps, S, ctypes.c_float(scale),
                         0 if dtype == torch.float32 else 1,
                         registry.stream_ptr(out))
                if err:
                    raise RuntimeError(f"{name} rps={rps}: CUDA error {err}")
            ms = _graph_ms(call)
            note = ""
            if name == "kernel":
                err = float((out - want).abs().max() / want.abs().max())
                if not err <= 2e-5:
                    raise AssertionError(f"rps={rps}: {err:.3g} off the op")
                note = f", {err:.2g} of max|out| off the op's call"
            what = f"rps={rps}" if name == "kernel" else f"{name}, rps={rps}"
            print(f"{'served' if served else 'full'} {str(dtype)[6:]} rings, "
                  f"{what}: {ms:.4f} ms in a graph{note}", flush=True)


if __name__ == "__main__":
    main()
