"""PyTorch port on the card: each hand-written CUDA kernel against its plain
PyTorch version at the main path's shapes, and the serving engine through
the kernels of each served path (paged DeepSeek-V3: fp8_gemm, moe_gemm,
paged_mla_decode; qwen3-14b: flash_prefill, paged_gqa_decode; dense
DeepSeek-V3 with MTP drafting: fp8_gemm, moe_gemm, mla_decode). The two
LogFMT kernels of the compressed ring all-reduce are held against their
plain versions here; the ring itself runs in phase (e) of chip_smoke.py.
Training: the FP8 linear's forward, dx and dw through fp8_gemm against
the plain products, a kernel on a grad-requiring input raising, and
three trainer steps on the card against the CPU.
Every test needs an NVIDIA GPU and nvcc (the kernels have no CPU mode) and
skips without one.

This file imports neither JAX nor the reference package, so it also runs
where JAX is not installed (the machine with the card):

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances, relative to the largest plain-version magnitude: fp32 outputs
2e-5 (the same exact products summed in another order; 1e-5 for
flash_prefill on fp32 operands; the paged pair's peaked case against a
float64 evaluation instead, see SPLIT_CASES), bf16 outputs 2^-7 (one
rounding step).
flash_prefill on bf16 operands is held per output row, relative to the
row's own norm, at 1e-2: rounding P to bf16 for P·V moves a row by about
2^-9 of itself, while a key dropped from a row of 2048 moves it by about
2e-2. LogFMT, as the reference holds its kernels
(tests/test_kernel_registry.py): codes within one level on under 0.1% of
entries (a last-ulp difference of log/exp flips a tie), mn within rtol
1e-5 / atol 1e-6, step within rtol 1e-5 / atol 1e-5; decoded values within
rtol 1e-4 / atol 1e-5 (fp32) or one bf16 rounding step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core import fp8, paged
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fp8_gemm import ops as fp8_ops
from repro_torch.kernels.logfmt import edge as logfmt_edge
from repro_torch.kernels.logfmt import ops as logfmt_ops
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

FP32_TOL = 2e-5
BF16_TOL = 2 ** -7
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _row_err(got, ref):
    """max over rows (last axis) of ||got - ref|| / ||ref||; a row that
    should be zero must come out zero."""
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    d, n = (got - ref).norm(dim=-1), ref.norm(dim=-1)
    return float(torch.where(n > 0, d / n.clamp_min(1e-30), d * 1e30).max())


def _capture(call):
    """``call`` run once on a side stream (build, warm-up), then captured in
    a CUDA graph inside a launch tally. Returns (graph, output, tally); the
    capture itself counts no launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = registry.launch_counts()
    with registry.tally() as t, torch.cuda.graph(graph):
        out = call()
    assert registry.launch_counts() == before
    return graph, out, t


# decode (M <= 64: one, four and eight slots) and prefill (65 and the 128
# and 1024 buckets) at every served shape, plus ragged N = 72
FP8_GEMM_SHAPES = list(dict.fromkeys(
    [(4, 16384, 7168), (512, 7168, 18432), (100, 200, 72)]
    + [(M, K, N) for M in (1, 4, 8, 65, 128, 1024)
       for K, N in fp8_ops.SERVED_KN.values()]
    + [(4, 7168, 72), (65, 7168, 72), (1024, 512, 72)]))


@pytest.mark.parametrize("shape", FP8_GEMM_SHAPES)
def test_fp8_gemm_kernel_matches_plain(card, shape):
    M, K, N = shape
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(M, K, generator=g, device=card, dtype=torch.bfloat16)
    w = torch.randn(K, N, generator=g, device=card) * 0.02
    before = fp8_ops.fp8_gemm.launches
    y = fp8_ops.fp8_matmul(x, w)
    assert fp8_ops.fp8_gemm.launches == before + 1
    xq, xs = fp8.quantize_tilewise(x)
    wq, ws = fp8.quantize_blockwise(w)
    assert _rel_err(y, fp8.scaled_matmul_ref(xq, xs, wq, ws)) <= FP32_TOL


# the FP8 linears of the card's training config (DeepSeek-V3's dense prefix
# at published widths): (d_in, d_out) per weight, at T = 1024 tokens (2 x
# 512) and at a token count that is no multiple of 128
TRAIN_LINEARS = sorted(fp8_ops.SERVED_KN.items())


@pytest.mark.parametrize("T", [1024, 200])
@pytest.mark.parametrize("weight,dims", TRAIN_LINEARS)
def test_fp8_linear_backward_through_fp8_gemm(card, weight, dims, T):
    """The FP8 linear's forward and both backward GEMMs on the kernel
    (``impl="pallas"``: three ``fp8_gemm`` launches) against the same
    products on the plain version (``impl="ref"``: ``scaled_matmul_ref``)
    on the card, same operands: dx (T, K=d_out) x (d_out, d_in), including
    ``w_kr``'s K = 64; dw (d_in, K=T) x (T, d_out), x2ᵀ a transposed view,
    M up to ``w_down``'s 18432."""
    d_in, d_out = dims
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(2, T // 2, d_in, generator=g, device=card).bfloat16()
    w = (torch.randn(d_in, d_out, generator=g, device=card) * 0.02
         ).bfloat16()
    ct = (torch.randn(2, T // 2, d_out, generator=g, device=card) * 1e-2
          ).bfloat16()
    out = {}
    for impl in ("pallas", "ref"):
        a = x.clone().requires_grad_(True)
        b = w.clone().requires_grad_(True)
        before = fp8_ops.fp8_gemm.launches
        y = fp8.fp8_linear(a, b, impl)
        dx, dw = torch.autograd.grad(y, (a, b), ct)
        launched = fp8_ops.fp8_gemm.launches - before
        assert launched == (3 if impl == "pallas" else 0)
        assert (y.dtype, dx.dtype, dw.dtype) == (torch.bfloat16,) * 3
        out[impl] = (y, dx, dw)
    # bf16 outputs of fp32 products within 2e-5 of each other: one bf16
    # rounding apart at most
    for got, ref in zip(out["pallas"], out["ref"]):
        assert _rel_err(got.detach(), ref.detach()) <= BF16_TOL


def test_fp8_linear_backward_products_match_plain_in_fp32(card):
    """The backward's products themselves, fp32, at w_down's dw (M =
    18432, K = 1024 tokens) and w_kr's dx (K = 64): within 2e-5."""
    g = torch.Generator(device=card).manual_seed(4)
    x2 = torch.randn(1024, 18432, generator=g, device=card).bfloat16()
    g2 = torch.randn(1024, 7168, generator=g, device=card) * 1e-3
    wkr = (torch.randn(7168, 64, generator=g, device=card) * 0.02
           ).bfloat16()
    gkr = torch.randn(1024, 64, generator=g, device=card) * 1e-3
    for a, b in ((x2.float().t(), g2), (gkr, wkr.t())):
        args = fp8_ops.operands(a, b)
        assert _rel_err(fp8_ops.fp8_gemm(*args),
                        fp8_ops.fp8_gemm.run_plain(*args)) <= FP32_TOL


def test_kernels_raise_under_autograd(card):
    """A kernel launch writes out of autograd's sight: with grad enabled and
    an input requiring grad, the CUDA dispatch raises (the experts' names
    ROADMAP A.8, the others A.9); under no_grad it launches."""
    x = torch.randn(4, 8, 256, device=card, requires_grad=True)
    w = torch.randn(4, 256, 128, device=card).bfloat16()
    with pytest.raises(RuntimeError, match="A.8"):
        moe_ops.grouped_matmul(x.bfloat16(), w)
    with pytest.raises(RuntimeError, match="A.9"):
        fp8_ops.fp8_matmul(x[0], w[0].float())
    with torch.no_grad():
        assert moe_ops.grouped_matmul(x.bfloat16(), w).shape == (4, 8, 128)
        assert fp8_ops.fp8_matmul(x[0], w[0].float()).shape == (8, 128)


def test_train_steps_on_the_card_match_the_cpu(card):
    """Three Trainer steps of the dense prefix at smoke width, bf16, FP8
    through fp8_gemm, on the card and on the CPU from one state, held as
    chip_smoke.py (g.3) holds them: losses within 2e-2 relative; each
    master leaf within 2.1 x the steps' summed lr of the CPU's element by
    element (Adam moves an element by at most about lr a step, whatever
    its gradient, so an element with a near-zero gradient may step the
    other way on the other device); each leaf's update within cosine 0.9
    of the CPU's."""
    import dataclasses
    from repro_torch.models.api import Model
    from repro_torch.train import optimizer as optim
    from repro_torch.train.trainer import Trainer, TrainConfig
    cfg = dataclasses.replace(smoke_config(get_config(
        "deepseek-v3-671b", family="dense", moe=None, num_layers=3,
        fp8_impl="pallas")), dtype="bfloat16", param_dtype="bfloat16")
    params = Model(cfg, device="cpu").init(seed=1)
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, TrainConfig(peak_lr=1e-3, warmup=1, total_steps=3),
                     global_batch=2, seq_len=32, device=dev)
        tr.params = optim.tree_map(lambda t: t.to(dev, copy=True), params)
        tr.opt_state = optim.init(tr.params)
        before = fp8_ops.fp8_gemm.launches
        out = tr.run(3)
        runs[dev] = (out["history"], tr.opt_state.master,
                     fp8_ops.fp8_gemm.launches - before)
    (hc, mc, nc), (hp, mp, npl) = runs["cuda"], runs["cpu"]
    assert nc == 3 * 3 * 5 and npl == 0   # 5 FP8 linears, 3 GEMMs, 3 steps
    for a, b in zip(hc, hp):
        assert abs(a["loss"] - b["loss"]) <= 2e-2 * abs(b["loss"])
    slack = 2.1 * sum(x["lr"] for x in hp)
    p0 = dict(optim.tree_items(params))
    cpu = dict(optim.tree_items(mp))
    for path, m in optim.tree_items(mc):
        d0, m = p0[path].float(), m.cpu()
        assert float((m - cpu[path]).abs().max()) <= slack, path
        cos = torch.nn.functional.cosine_similarity(
            (m - d0).flatten().double(), (cpu[path] - d0).flatten().double(),
            dim=0)
        assert float(cos) >= 0.9, path


def _spread_weights(g, E, D, F, device):
    """bf16 ``(E, D, F)`` expert weights, N(0, 0.02) times 10^u for each
    128 x 128 block, u uniform in [-3, 3]: block magnitudes span six
    decades, so a kernel that applies a wrong block's scale is off by far
    more than the tolerance."""
    KB, FB = -(-D // 128), -(-F // 128)
    w = torch.randn(E, KB * 128, FB * 128, generator=g, device=device)
    u = torch.rand(E, KB, 1, FB, 1, generator=g, device=device) * 6 - 3
    w.mul_(0.02).view(E, KB, 128, FB, 128).mul_(10 ** u)
    return w[:, :D, :F].bfloat16()


def _block_err(got, ref):
    """``_rel_err`` within each expert's 128-wide F block, the largest: a
    block whose scale is wrong fails even where other blocks dominate the
    output's range."""
    got, ref = got.float(), ref.float()
    err, worst = (got - ref).abs(), 0.0
    for f0 in range(0, ref.shape[-1], 128):
        d = err[..., f0:f0 + 128].amax(dim=(1, 2))
        m = ref[..., f0:f0 + 128].abs().amax(dim=(1, 2)).clamp_min(1e-30)
        worst = max(worst, float((d / m).max()))
    return worst


def _fp8_operands(g, M, K, N, device, spread=False):
    """Quantized x and a K-contiguous weight (the load-time layout)."""
    x = torch.randn(M, K, generator=g, device=device)
    w = (_spread_weights(g, 1, K, N, device)[0].float() if spread
         else torch.randn(K, N, generator=g, device=device) * 0.02)
    xq, xs = fp8.quantize_tilewise(x)
    wq, ws = fp8.quantize_blockwise(w)
    return xq, xs, fp8.k_major(wq), ws


@pytest.mark.parametrize("shape", [(4, 7168, 18432), (4, 7168, 64),
                                   (8, 16384, 7168), (1024, 16384, 7168),
                                   (65, 7168, 72)])
def test_fp8_gemm_applies_each_blocks_scale(card, shape):
    """Weights whose 128 x 128 block magnitudes span six decades, held over
    the whole output and within each 128-wide N block: a kernel that takes
    a wrong block's scale fails."""
    g = torch.Generator(device=card).manual_seed(1)
    args = _fp8_operands(g, *shape, card, spread=True)
    y = fp8_ops.fp8_gemm(*args)
    ref = fp8_ops.fp8_gemm.run_plain(*args)
    assert _rel_err(y, ref) <= FP32_TOL
    assert _block_err(y[None], ref[None]) <= FP32_TOL


@pytest.mark.parametrize("shape", [(4, 16384, 7168), (4, 7168, 64),
                                   (17, 7168, 1536), (1024, 7168, 18432),
                                   (1024, 7168, 512)])
def test_fp8_gemm_gives_the_same_bits_every_call(card, shape):
    """Split-K partials (decode's stream-K segments, prefill's K splits of
    a narrow N) are summed in a fixed order: no float atomics."""
    g = torch.Generator(device=card).manual_seed(2)
    args = _fp8_operands(g, *shape, card)
    a = fp8_ops.fp8_gemm(*args)
    b = fp8_ops.fp8_gemm(*args)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(4, 7168, 18432), (4, 7168, 64),
                                   (1024, 512, 16384), (1024, 7168, 64)])
def test_fp8_gemm_graph_replay_equals_eager(card, shape):
    """The launch plan reads nothing on the host: a captured call, replayed
    after its input changed in place, equals an eager call on that input;
    the capture's tally holds its one launch."""
    g = torch.Generator(device=card).manual_seed(3)
    xq, xs, wq, ws = _fp8_operands(g, *shape, card)
    graph, out, t = _capture(lambda: fp8_ops.fp8_gemm(xq, xs, wq, ws))
    assert t == {"fp8_gemm": 1}
    x2, s2 = fp8.quantize_tilewise(torch.randn(
        xq.shape, generator=g, device=card))
    xq.copy_(x2)
    xs.copy_(s2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fp8_ops.fp8_gemm(xq, xs, wq, ws))


def test_fp8_gemm_refuses_weights_it_does_not_take(card):
    """The CUDA route never copies a weight: a row-major (N-contiguous)
    weight and a base off the 16-byte boundary raise."""
    g = torch.Generator(device=card).manual_seed(4)
    xq, xs, wq, ws = _fp8_operands(g, 4, 256, 128, card)
    with pytest.raises(ValueError, match="K-contiguous"):
        fp8_ops.fp8_gemm(xq, xs, wq.contiguous(), ws)
    buf = torch.zeros(128 * 256 + 16, dtype=torch.uint8, device=card)
    off = buf[1:1 + 128 * 256].view(128, 256)
    off.copy_(wq.t().view(torch.uint8))
    with pytest.raises(ValueError, match="16-byte"):
        fp8_ops.fp8_gemm(xq, xs, off.t().view(fp8.E4M3), ws)


# (E, C, D, F): the bf16 routed experts of qwen3-moe-30b-a3b (2048 -> 768
# -> 2048) and llama4-maverick (5120 -> 8192 -> 5120) at decode's C = 8 and
# at the capacity of the 2048-token prefill bucket (top-8: 160; top-1: 24)
MOE_BF16_SHAPES = [(128, 8, 2048, 768), (128, 8, 768, 2048),
                   (128, 160, 2048, 768), (128, 160, 768, 2048),
                   (128, 8, 5120, 8192), (128, 8, 8192, 5120),
                   (128, 24, 5120, 8192), (128, 24, 8192, 5120)]


@pytest.mark.parametrize("fmt", ["bf16", "e4m3"])
@pytest.mark.parametrize("dims", [(256, 8, 7168, 2048), (256, 8, 2048, 7168),
                                  (256, 40, 7168, 2048), (3, 40, 72, 96),
                                  *MOE_BF16_SHAPES])
def test_moe_gemm_kernel_matches_plain(card, dims, fmt):
    """Both weight formats, on weights whose block magnitudes span six
    decades, held over the whole output and within each F block; the plain
    version runs expert by expert (one fp32 copy of a 256-expert weight is
    15 GB)."""
    E, C, D, F = dims
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(E, C, D, generator=g, device=card).bfloat16()
    w = _spread_weights(g, E, D, F, card)
    if fmt == "e4m3":
        w = fp8.Fp8Experts.quantize(w)
    before = moe_ops.grouped_matmul.launches
    y = moe_ops.grouped_matmul(x, w)
    assert moe_ops.grouped_matmul.launches == before + 1
    assert y.shape == (E, C, F) and y.dtype == torch.bfloat16
    ref = torch.cat([moe_ops.grouped_matmul.run_plain(x[e:e + 1],
                                                      _expert(w, e))
                     for e in range(E)])
    assert _rel_err(y, ref) <= BF16_TOL
    assert _block_err(y, ref) <= BF16_TOL


@pytest.mark.parametrize("fmt", ["bf16", "e4m3"])
@pytest.mark.parametrize("hot", [1, 2])
@pytest.mark.parametrize("C", [8, 40, 256])
@pytest.mark.parametrize("DF", [(200, 320), (7168, 2048)])
def test_moe_gemm_one_hot_rows_read_the_weight_exactly(card, fmt, hot, C,
                                                       DF):
    """With x[e, c] = e_d, y[e, c] is row d of expert e's weight: one
    product in an fp32 sum of zeros, exact. So the kernel must return the
    weight it holds bit for bit: for codes ``dequant()``, each code times
    its own block's scale in fp32, rounded once to bf16. Two hot entries,
    rows d and d ^ 1 of one scale block, must give the fp32 sum of the two
    held rows rounded once (exact or decided by the larger term): a kernel
    that scaled the sum of codes instead of each code fails here. At (200,
    320) calls of C rows walk every row (D and F ragged); at full width
    one call's rows spread over the depth."""
    D, F = DF
    E = 2
    g = torch.Generator(device=card).manual_seed(1)
    w = _spread_weights(g, E, D, F, card)
    if fmt == "e4m3":
        w = fp8.Fp8Experts.quantize(w)
        held = w.dequant()
    else:
        held = w
    if D <= 256:
        order = torch.stack([torch.randperm(D, generator=g, device=card)
                             for _ in range(E)])
        calls = [order[:, (torch.arange(c0, c0 + C, device=card) % D)]
                 for c0 in range(0, D, C)]
    else:
        step = torch.arange(C, device=card) * (D // C)
        calls = [step + torch.randint(0, D // C, (E, C), generator=g,
                                      device=card)]
    for rows in calls:
        picks = [rows, rows ^ 1][:hot]
        x = torch.zeros(E, C, D, device=card, dtype=torch.bfloat16)
        want = torch.zeros(E, C, F, device=card)
        for r in picks:
            x.scatter_(2, r[..., None], 1.0)
            want += torch.gather(held, 1, r[..., None].expand(E, C, F))
        y = moe_ops.grouped_matmul(x, w)
        assert torch.equal(y, want.bfloat16()), (fmt, hot, C, DF)


def _expert(w, e):
    """Expert ``e`` of ``w`` as a one-expert stack, in either format."""
    if isinstance(w, fp8.Fp8Experts):
        return fp8.Fp8Experts(w.wq[e:e + 1], w.ws[e:e + 1], w.dtype, w.d_in,
                              w.d_out)
    return w[e:e + 1]


@pytest.mark.parametrize("fmt", ["bf16", "e4m3"])
def test_moe_gemm_graph_replay_equals_eager(card, fmt):
    """The wrapper only pads and allocates: a captured call at the decode
    shape, replayed after x changed in place, equals an eager call on the
    new x; each replay adds the tally's one launch."""
    E, C, D, F = 256, 8, 7168, 2048
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(E, C, D, generator=g, device=card).bfloat16()
    w = _spread_weights(g, E, D, F, card)
    if fmt == "e4m3":
        w = fp8.Fp8Experts.quantize(w)
    graph, out, t = _capture(lambda: moe_ops.grouped_matmul(x, w))
    assert t == {"moe_gemm": 1}
    x.copy_(torch.randn(E, C, D, generator=g, device=card))
    before = moe_ops.grouped_matmul.launches
    for _ in range(2):
        graph.replay()
        registry.add_launches(t, 1)
    torch.cuda.synchronize()
    assert moe_ops.grouped_matmul.launches == before + 2
    assert torch.equal(out, moe_ops.grouped_matmul(x, w))


def test_kernel_launch_under_capture_needs_a_tally(card):
    """A kernel captured outside ``registry.tally()`` would go uncounted at
    every replay: its launch raises instead."""
    x = torch.randn(2, 8, 128, device=card).bfloat16()
    w = torch.randn(2, 128, 128, device=card).bfloat16()
    moe_ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside registry.tally"):
        with torch.cuda.graph(graph):
            moe_ops.grouped_matmul(x, w)


def test_moe_gemm_kernel_refuses_fp32(card):
    x = torch.ones(2, 16, 32, device=card)
    with pytest.raises(TypeError, match="bf16"):
        moe_ops.grouped_matmul(x, torch.ones(2, 32, 128, device=card))


def test_moe_gemm_kernel_refuses_bad_containers(card):
    x = torch.ones(2, 16, 256, device=card, dtype=torch.bfloat16)
    w = fp8.Fp8Experts.quantize(torch.ones(2, 256, 128, device=card,
                                           dtype=torch.bfloat16))
    bad = fp8.Fp8Experts(w.wq, w.ws[:, :1], w.dtype, w.d_in, w.d_out)
    with pytest.raises(ValueError, match="scales"):
        moe_ops.grouped_matmul(x, bad)
    fp32 = fp8.Fp8Experts(w.wq, w.ws, torch.float32, w.d_in, w.d_out)
    with pytest.raises(TypeError, match="bf16 weights"):
        moe_ops.grouped_matmul(x, fp32)


@pytest.mark.parametrize("storage", ["fp8", "bf16"])
def test_paged_mla_decode_kernel_matches_plain(card, storage):
    B, H, R, Rr, page, pp = 4, 128, 512, 64, 8, 128
    P = B * pp
    g = torch.Generator(device=card).manual_seed(1)
    qa = torch.randn(B, H, R, generator=g, device=card)
    qr = torch.randn(B, H, Rr, generator=g, device=card)
    ckv = torch.randn(P + 1, page, R, generator=g, device=card)
    kr = torch.randn(P + 1, page, Rr, generator=g, device=card)
    if storage == "fp8":
        ckv, cs = paged.quantize_vecs(ckv)
        kr, ks = paged.quantize_vecs(kr)
        ckv, kr = ckv.view(torch.uint8), kr.view(torch.uint8)
    else:
        ckv, kr = ckv.bfloat16(), kr.bfloat16()
        cs = ks = torch.ones(P + 1, page, device=card)
    table = torch.randperm(P, generator=g, device=card).reshape(B, pp).int()
    qpos = torch.tensor([63, 299, 699, 1023], dtype=torch.int32, device=card)
    args = (qa, qr, ckv, kr, cs, ks, table, qpos)
    before = paged_ops.paged_mla_decode.launches
    out = paged_ops.paged_mla_decode(*args, scale=0.0722)
    assert paged_ops.paged_mla_decode.launches == before + 1
    ref = paged_ops.paged_mla_decode.run_plain(*args, scale=0.0722)
    assert _rel_err(out, ref) <= FP32_TOL


# (B, H, R, Rr, T, layout): DeepSeek-V3's dense decode (full rings of 1024;
# in fp32 too, the smoke width's cache at published width, which the split
# kernel copies straight into two fp32 tiles to fit its shared memory), a
# ragged T with a slot whose ring is empty, a ring past one wrap, the smoke
# width, and what only a split kernel over a ring can get wrong: "stale"
# (every row holds a position, those past qpos from a slot's earlier
# occupant), "last" (valid rows only in the last split), "ragged" (T = 1000,
# every row valid: a last split of 40 rows), "served" (the main path's
# contexts 600-900 in rings of 1024)
MLA_CASES = [(4, 128, 512, 64, 1024, "full"), (3, 128, 512, 64, 1000, "empty"),
             (4, 128, 512, 64, 1024, "wrapped"), (2, 4, 32, 8, 40, "empty"),
             (4, 128, 512, 64, 1024, "stale"), (4, 128, 512, 64, 1024, "last"),
             (4, 128, 512, 64, 1000, "ragged"),
             (4, 128, 512, 64, 1024, "served")]


def _mla_inputs(card, dims, dtype, seed=4):
    B, H, R, Rr, T, layout = dims
    g = torch.Generator(device=card).manual_seed(seed)
    qa = torch.randn(B, H, R, generator=g, device=card)
    qr = torch.randn(B, H, Rr, generator=g, device=card)
    ckv = torch.randn(B, T, R, generator=g, device=card).to(dtype)
    kr = torch.randn(B, T, Rr, generator=g, device=card).to(dtype)
    t = torch.arange(T, dtype=torch.int32, device=card).expand(B, T)
    b = torch.arange(B, dtype=torch.int32, device=card)
    pos = t.clone()
    qpos = torch.full((B,), T - 1, dtype=torch.int32, device=card)
    if layout == "wrapped":             # rows 0..w hold positions T..T+w
        w = 300 + 100 * b
        pos = torch.where(t <= w[:, None], t + T, t)
        qpos = w + T
    elif layout == "empty":             # ragged validity, slot 0 empty
        lens = (T * (1 + b)) // (B + 1)
        pos = torch.where(t < lens[:, None], t, -1)
        pos[0] = -1
        qpos = lens - 1
    elif layout == "stale":             # rows past qpos hold larger positions
        qpos = 299 + 233 * b
    elif layout == "last":              # 1-40 valid rows at the ring's end
        n = 1 + 13 * b
        pos = torch.where(t >= T - n[:, None], t - (T - n[:, None]), -1)
        qpos = n - 1
    elif layout == "served":
        ctx = torch.tensor([600, 700, 800, 900], dtype=torch.int32,
                           device=card)[:B]
        pos = torch.where(t < ctx[:, None], t, -1)
        qpos = ctx - 1
    return qa, qr, ckv, kr, pos.int().contiguous(), qpos.int()


def _poison_invalid_rows(args):
    """Copies of the rings with every row that is not valid (pos < 0 or
    pos > qpos) set to NaN."""
    qa, qr, ckv, kr, pos, qpos = args
    dead = (pos < 0) | (pos > qpos[:, None])
    ckv, kr = ckv.clone(), kr.clone()
    ckv[dead] = float("nan")
    kr[dead] = float("nan")
    return qa, qr, ckv, kr, pos, qpos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", MLA_CASES)
def test_mla_decode_kernel_matches_plain(card, dims, dtype):
    args = _mla_inputs(card, dims, dtype)
    before = mla_ops.mla_decode.launches
    out = mla_ops.mla_decode(*args, scale=0.0722)
    assert mla_ops.mla_decode.launches == before + 1
    ref = mla_ops.mla_decode.run_plain(*args, scale=0.0722)
    assert _rel_err(out, ref) <= FP32_TOL
    if dims[-1] == "empty":             # no valid row: exactly zero
        assert bool((out[0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", MLA_CASES)
def test_mla_decode_never_reads_invalid_rows(card, dims, dtype):
    """Only valid rows are copied: rings whose empty, stale and wrapped-over
    rows are NaN give the clean output bit for bit."""
    args = _mla_inputs(card, dims, dtype)
    out = mla_ops.mla_decode(*args, scale=0.0722)
    assert torch.equal(out, mla_ops.mla_decode(*_poison_invalid_rows(args),
                                               scale=0.0722))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [MLA_CASES[0], MLA_CASES[3], MLA_CASES[7]])
def test_mla_decode_gives_the_same_bits_every_call(card, dims, dtype):
    """Rows are kept in ring order and the splits merged in a fixed order:
    no float atomics."""
    args = _mla_inputs(card, dims, dtype)
    a = mla_ops.mla_decode(*args, scale=0.0722)
    b = mla_ops.mla_decode(*args, scale=0.0722)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_graph_replay_equals_eager(card, dtype):
    """The split plan reads nothing on the host: a captured call, replayed
    after its queries, rings, pos and qpos changed in place (full rings to
    the served contexts), equals an eager call on the new inputs; the
    capture's tally holds its one launch."""
    args = _mla_inputs(card, MLA_CASES[0], dtype)
    graph, out, t = _capture(lambda: mla_ops.mla_decode(*args, scale=0.0722))
    assert t == {"mla_decode": 1}
    for x, y in zip(args, _mla_inputs(card, MLA_CASES[7], dtype, seed=7)):
        x.copy_(y)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, mla_ops.mla_decode(*args, scale=0.0722))


def test_mla_decode_kernel_refuses_other_caches(card):
    qa = torch.ones(1, 8, 32, device=card)
    qr = torch.ones(1, 8, 8, device=card)
    pos = torch.zeros(1, 16, dtype=torch.int32, device=card)
    qpos = torch.zeros(1, dtype=torch.int32, device=card)
    half = torch.ones(1, 16, 32, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        mla_ops.mla_decode(qa, qr, half, half[..., :8], pos, qpos, scale=1.0)
    narrow = torch.ones(1, 16, 4, device=card, dtype=torch.bfloat16)
    wide = torch.ones(1, 16, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        mla_ops.mla_decode(qa, qa[..., :4], wide, narrow, pos, qpos,
                           scale=1.0)


def test_mla_decode_refuses_rows_past_its_shared_memory(card):
    """R over 512 raises before the launch; fp32 rows of R + Rr = 640 need
    more shared memory than a CTA may have, so the launch is refused and
    the wrapper raises, and the next call runs as before."""
    dims = (1, 16, 512, 128, 64, "full")
    wide = _mla_inputs(card, dims, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        mla_ops.mla_decode(*wide, scale=0.0722)
    qa, qr, ckv, kr, pos, qpos = _mla_inputs(card, (1, 16, 520, 64, 64,
                                                    "full"), torch.float32)
    with pytest.raises(ValueError, match="R up to 512"):
        mla_ops.mla_decode(qa, qr, ckv, kr, pos, qpos, scale=0.0722)
    args = _mla_inputs(card, MLA_CASES[3], torch.float32)
    out = mla_ops.mla_decode(*args, scale=0.0722)
    ref = mla_ops.mla_decode.run_plain(*args, scale=0.0722)
    assert _rel_err(out, ref) <= FP32_TOL


# (B, H, KV, hd, page, pp, contexts): qwen3-14b's decode (G = 5, not a
# power of two), then the reference's parity shapes (G = 4, 1, 8), then the
# decode of glm4-9b (G = 16), yi-34b (G = 7: the runtime-G branch, as 16),
# qwen3-moe-30b-a3b (G = 8) and qwen1.5-4b (G = 1, 20 heads) at published
# widths, and seamless-m4t-large-v2's decoder (G = 1 at head_dim 64)
GQA_CASES = [(4, 40, 8, 128, 8, 256, (600, 900, 1200, 1500)),
             (2, 8, 2, 32, 16, 4, (33, 36)),
             (1, 4, 4, 64, 8, 6, (24,)),
             (3, 16, 2, 32, 4, 8, (16, 19, 22)),
             (4, 32, 2, 128, 8, 256, (600, 900, 1200, 1500)),
             (4, 56, 8, 128, 8, 256, (600, 900, 1200, 1500)),
             (4, 32, 4, 128, 8, 256, (600, 900, 1200, 1500)),
             (4, 20, 20, 128, 8, 256, (600, 900, 1200, 1500)),
             (4, 16, 16, 64, 8, 256, (600, 900, 1200, 1500))]


@pytest.mark.parametrize("storage", ["fp8", "bf16", "fp32"])
@pytest.mark.parametrize("dims", GQA_CASES)
def test_paged_gqa_decode_kernel_matches_plain(card, dims, storage):
    B, H, KV, hd, page, pp, ctx = dims
    P = B * pp
    g = torch.Generator(device=card).manual_seed(2)
    q = torch.randn(B, H, hd, generator=g, device=card)
    k = torch.randn(P + 1, page, KV, hd, generator=g, device=card)
    v = torch.randn(P + 1, page, KV, hd, generator=g, device=card)
    if storage == "fp8":
        k, ks = paged.quantize_vecs(k, vec_ndim=2)
        v, vs = paged.quantize_vecs(v, vec_ndim=2)
        k, v = k.view(torch.uint8), v.view(torch.uint8)
    elif storage == "bf16":             # the engine's native pool: no scales
        k, v = k.bfloat16(), v.bfloat16()
        ks = vs = None
    else:                               # explicit unit scales
        ks = vs = torch.ones(P + 1, page, device=card)
    table = torch.randperm(P, generator=g, device=card).reshape(B, pp).int()
    qpos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32, device=card)
    args = (q, k, v, ks, vs, table, qpos)
    before = paged_ops.paged_gqa_decode.launches
    out = paged_ops.paged_gqa_decode(*args, scale=hd ** -0.5)
    assert paged_ops.paged_gqa_decode.launches == before + 1
    ref = paged_ops.paged_gqa_decode.run_plain(*args, scale=hd ** -0.5)
    assert _rel_err(out, ref) <= FP32_TOL


# --- split-KV: what only a split kernel can get wrong ---------------------------
#
# Both paged kernels spread a slot's rows over splits of `rps` rows (the
# wrapper's plan for this card) and merge the partial softmaxes in a combine
# pass. Cases, at the main paths' widths: "edges" puts the four slots at a
# one-row context (qpos = 0), a context ending on a split boundary, one row
# past it, and the full pp*page rows; "single" is one slot at the full
# context (the most splits a slot gets); "ragged" holds slots 20x apart in one
# batch; "peaked" scales q by 30, so each head's softmax peaks in a single
# split and a wrong rescale in the combine shows (on N(0,1) queries it
# hardly does). At x30 the scores reach a few hundred, where fp32 rounding
# alone moves the output by 1e-5 of its largest value: the fp32 plain
# version of paged_mla_decode is itself 3.3e-5 away from a float64
# evaluation there, the kernel 0.9-1.1e-5. So the peaked case is held, at
# the same 2e-5, against the function evaluated in float64 (`_exact`), on
# the same dequantized values.
SPLIT_CASES = ("edges", "single", "ragged", "peaked")


def _exact(q_parts, pools, scales, table, qpos, scale, grouped):
    """softmax(sum_i q_i . pool_i * scale) . pools[0] over the rows <= qpos,
    in float64: the paged ops' function on the dequantized pools."""
    B, pp = table.shape
    page = pools[0].shape[1]
    rows = []
    for x, sx in zip(pools, scales):
        x = paged.e4m3_decode(x) if x.dtype == torch.uint8 else x
        x = x.double()
        if sx is not None:
            x = x * sx.double().reshape(sx.shape + (1,) * (x.dim() - 2))
        rows.append(x[table.long()].reshape(B, pp * page, *x.shape[2:]))
    if not grouped:                     # MLA: every head reads the row
        s = sum(torch.einsum("bhr,btr->bht", q.double(), r)
                for q, r in zip(q_parts, rows))
        vals = rows[0]
    else:                               # GQA: heads factor as (KV, G)
        KV = rows[0].shape[2]
        q = q_parts[0].double()
        q = q.reshape(B, KV, q.shape[1] // KV, q.shape[2])
        s = torch.einsum("bkgh,btkh->bkgt", q, rows[0]).flatten(1, 2)
        vals = rows[1]
    valid = torch.arange(pp * page, device=table.device)[None] <= qpos[:, None]
    p = torch.softmax((s * scale).masked_fill(~valid[:, None], -1e300), -1)
    if not grouped:
        return torch.einsum("bht,btr->bhr", p, vals)
    p = p.reshape(B, KV, -1, p.shape[-1])
    return torch.einsum("bkgt,btkh->bkgh", p, vals).flatten(1, 2)


def _split_contexts(case, rps, rows):
    return {"edges": (1, rps, rps + 1, rows), "single": (rows,),
            "ragged": (50, 1000, 300), "peaked": (300, 700, rows, 64)}[case]


def _paged_pool(card, g, shape, storage, vec_ndim):
    """A pool of ``shape`` and its per-token scales as the engine holds
    them: E4M3 bytes with scales, or bf16 / fp32 with ``None`` scales."""
    x = torch.randn(*shape, generator=g, device=card)
    if storage == "fp8":
        x, sx = paged.quantize_vecs(x, vec_ndim=vec_ndim)
        return x.view(torch.uint8), sx
    return x.to(torch.bfloat16 if storage == "bf16" else torch.float32), None


def _poison_past_qpos(pools, scales, table, qpos):
    """Copies with every pool row past its slot's qpos (and its scales) set
    to NaN (0x7f in E4M3)."""
    page = pools[0].shape[1]
    pp = table.shape[1]
    t = torch.arange(pp * page, device=table.device)
    dead = t[None, :] > qpos[:, None].long()               # (B, rows)
    pages = table.long()[:, :, None].expand(-1, -1, page).reshape(len(qpos), -1)
    offs = (t % page)[None, :].expand_as(pages)
    pg, of = pages[dead], offs[dead]
    out_p, out_s = [], []
    for x, sx in zip(pools, scales):
        x = x.clone()
        x[pg, of] = 0x7F if x.dtype == torch.uint8 else float("nan")
        out_p.append(x)
        if sx is not None:
            sx = sx.clone()
            sx[pg, of] = float("nan")
        out_s.append(sx)
    return out_p, out_s


@pytest.mark.parametrize("storage", ["fp8", "bf16"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_paged_mla_decode_split_cases(card, case, storage):
    H, R, Rr, page, pp = 128, 512, 64, 8, 128
    rows = pp * page
    rps, _ = paged_ops.mla_split_plan(4, H, page, pp,
                                      registry.sm_count(card))
    ctx = _split_contexts(case, rps, rows)
    B = len(ctx)
    P = B * pp
    g = torch.Generator(device=card).manual_seed(5)
    qa = torch.randn(B, H, R, generator=g, device=card)
    qr = torch.randn(B, H, Rr, generator=g, device=card)
    if case == "peaked":
        qa, qr = qa * 30, qr * 30
    ckv, cs = _paged_pool(card, g, (P + 1, page, R), storage, 1)
    kr, ks = _paged_pool(card, g, (P + 1, page, Rr), storage, 1)
    table = torch.randperm(P, generator=g, device=card).reshape(B, pp).int()
    qpos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32, device=card)
    scale = 192 ** -0.5
    before = paged_ops.paged_mla_decode.launches
    out = paged_ops.paged_mla_decode(qa, qr, ckv, kr, cs, ks, table, qpos,
                                     scale=scale)
    assert paged_ops.paged_mla_decode.launches == before + 1
    if case == "peaked":
        ref = _exact([qa, qr], [ckv, kr], [cs, ks], table, qpos, scale, False)
    else:
        ref = paged_ops.paged_mla_decode.run_plain(qa, qr, ckv, kr, cs, ks,
                                                   table, qpos, scale=scale)
    assert _rel_err(out, ref) <= FP32_TOL
    if storage == "bf16":                # null scales are unit scales
        ones = torch.ones(P + 1, page, device=card)
        assert torch.equal(out, paged_ops.paged_mla_decode(
            qa, qr, ckv, kr, ones, ones, table, qpos, scale=scale))
    (pc, pk), (psc, psk) = _poison_past_qpos([ckv, kr], [cs, ks], table, qpos)
    assert torch.equal(out, paged_ops.paged_mla_decode(
        qa, qr, pc, pk, psc, psk, table, qpos, scale=scale))


@pytest.mark.parametrize("storage", ["fp8", "bf16", "fp32"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_paged_gqa_decode_split_cases(card, case, storage):
    H, KV, hd, page, pp = 40, 8, 128, 8, 256
    rows = pp * page
    esize = {"fp8": 1, "bf16": 2, "fp32": 4}[storage]
    rps, _ = paged_ops.gqa_split_plan(4, KV, hd, esize, page, pp,
                                      registry.sm_count(card))
    ctx = _split_contexts(case, rps, rows)
    B = len(ctx)
    P = B * pp
    g = torch.Generator(device=card).manual_seed(6)
    q = torch.randn(B, H, hd, generator=g, device=card)
    if case == "peaked":
        q = q * 30
    k, ks = _paged_pool(card, g, (P + 1, page, KV, hd), storage, 2)
    v, vs = _paged_pool(card, g, (P + 1, page, KV, hd), storage, 2)
    table = torch.randperm(P, generator=g, device=card).reshape(B, pp).int()
    qpos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32, device=card)
    scale = hd ** -0.5
    before = paged_ops.paged_gqa_decode.launches
    out = paged_ops.paged_gqa_decode(q, k, v, ks, vs, table, qpos,
                                     scale=scale)
    assert paged_ops.paged_gqa_decode.launches == before + 1
    if case == "peaked":
        ref = _exact([q], [k, v], [ks, vs], table, qpos, scale, True)
    else:
        ref = paged_ops.paged_gqa_decode.run_plain(q, k, v, ks, vs, table,
                                                   qpos, scale=scale)
    assert _rel_err(out, ref) <= FP32_TOL
    (pk, pv), (psk, psv) = _poison_past_qpos([k, v], [ks, vs], table, qpos)
    assert torch.equal(out, paged_ops.paged_gqa_decode(
        q, pk, pv, psk, psv, table, qpos, scale=scale))


# (B, S, T, H, KV, hd, dtype, causal): qwen3-14b's largest bucket, the
# reference's parity shapes, ragged tiles (S, T not multiples of 64 or of
# the bf16 kernel's 128-row query and key tiles), and the bf16 kernel's
# other head dims (64- and 128-byte swizzled rows)
FLASH_CASES = [(1, 2048, 2048, 40, 8, 128, torch.bfloat16, True),
               (2, 16, 16, 4, 2, 32, torch.float32, True),
               (2, 16, 16, 4, 2, 32, torch.bfloat16, True),
               (1, 8, 8, 4, 4, 16, torch.float32, True),
               (2, 32, 32, 8, 2, 64, torch.float32, True),
               (1, 128, 128, 4, 2, 32, torch.float32, True),
               (2, 16, 16, 2, 1, 32, torch.float32, False),
               (2, 100, 100, 10, 2, 64, torch.bfloat16, True),
               (1, 70, 130, 4, 4, 128, torch.bfloat16, False),
               (2, 100, 100, 10, 2, 128, torch.float32, True),
               (3, 200, 200, 10, 2, 128, torch.bfloat16, True),
               (2, 70, 130, 10, 2, 64, torch.bfloat16, False),
               (2, 256, 256, 10, 2, 32, torch.bfloat16, True),
               (2, 256, 256, 10, 2, 64, torch.bfloat16, True),
               # the 2048 bucket of glm4-9b (G = 16), qwen1.5-4b (G = 1),
               # yi-34b (G = 7) and qwen3-moe-30b-a3b (G = 8)
               (1, 2048, 2048, 32, 2, 128, torch.bfloat16, True),
               (1, 2048, 2048, 20, 20, 128, torch.bfloat16, True),
               (1, 2048, 2048, 56, 8, 128, torch.bfloat16, True),
               (1, 2048, 2048, 32, 4, 128, torch.bfloat16, True),
               # seamless-m4t-large-v2's decoder (G = 1 at head_dim 64)
               # and llama-3.2-vision-90b's self blocks (64 over 8)
               (1, 2048, 2048, 16, 16, 64, torch.bfloat16, True),
               (1, 2048, 2048, 64, 8, 128, torch.bfloat16, True)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_prefill_kernel_matches_plain(card, case):
    B, S, T, H, KV, hd, dt, causal = case
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn(B, S, H, hd, generator=g, device=card).to(dt)
    k = torch.randn(B, T, KV, hd, generator=g, device=card).to(dt)
    v = torch.randn(B, T, KV, hd, generator=g, device=card).to(dt)
    qp = torch.arange(S, dtype=torch.int32, device=card).expand(B, S)
    # ragged rows as in the reference's cases: row b keeps T - b real keys
    t = torch.arange(T, dtype=torch.int32, device=card)
    lens = T - torch.arange(B, dtype=torch.int32, device=card)
    kp = torch.where(t[None, :] < lens[:, None], t[None, :], -1)
    args = (q, k, v, qp, kp)
    before = flash_ops.flash_prefill.launches
    out = flash_ops.flash_prefill(*args, causal=causal, scale=hd ** -0.5)
    assert flash_ops.flash_prefill.launches == before + 1
    ref = flash_ops.flash_prefill.run_plain(*args, causal=causal,
                                            scale=hd ** -0.5)
    err = _rel_err(out, ref) if dt == torch.float32 else _row_err(out, ref)
    assert err <= FLASH_TOL[dt]


# (S, T, H, KV, start): a prefill chunk of S queries at positions
# [start, start + S) against every row of the slot's T gathered keys:
# qwen3-14b's chunk (two 128-row query tiles of a C = 256 chunk, 40 over 8
# heads) and smoke-sized ones; most key blocks lie wholly above every query
FLASH_CHUNK_CASES = [(256, 2048, 40, 8, 1280), (256, 2048, 40, 8, 0),
                     (256, 1024, 10, 2, 512), (16, 64, 10, 2, 8),
                     (8, 64, 4, 4, 40)]


@pytest.mark.parametrize("case", FLASH_CHUNK_CASES)
def test_flash_prefill_at_a_chunk_shape(card, case):
    S, T, H, KV, start = case
    hd = 128
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(1, S, H, hd, generator=g, device=card).bfloat16()
    k = torch.randn(1, T, KV, hd, generator=g, device=card).bfloat16()
    v = torch.randn(1, T, KV, hd, generator=g, device=card).bfloat16()
    qp = torch.arange(start, start + S, dtype=torch.int32, device=card)[None]
    kp = torch.arange(T, dtype=torch.int32, device=card)[None]
    before = flash_ops.flash_prefill.launches
    out = flash_ops.flash_prefill(q, k, v, qp, kp, causal=True,
                                  scale=hd ** -0.5)
    assert flash_ops.flash_prefill.launches == before + 1
    ref = flash_ops.flash_prefill.run_plain(q, k, v, qp, kp, causal=True,
                                            scale=hd ** -0.5)
    assert _row_err(out, ref) <= FLASH_TOL[torch.bfloat16]


@pytest.mark.parametrize("storage", ["fp8", "bf16"])
def test_page_write_chunk_on_the_card(card, storage):
    """The chunk's indexed page write on the card against the same write on
    the CPU: every page but the trash page (several rows of a run may land
    there, in no fixed order) bit for bit."""
    g = torch.Generator().manual_seed(6)
    P, page, KV, hd, B, C = 40, 8, 8, 128, 3, 32
    vals = torch.randn(B, C, KV, hd, generator=g)
    table = torch.randperm(P, generator=g)[:B * 8].reshape(B, 8).int()
    table[2, 2:] = P                                # slot 2 ends early
    start = torch.tensor([0, 32, 8], dtype=torch.int32)
    if storage == "fp8":
        pool = torch.zeros(P + 1, page, KV, hd, dtype=torch.uint8)
        vals, _ = paged.quantize_vecs(vals, vec_ndim=2)
    else:
        pool = torch.zeros(P + 1, page, KV, hd, dtype=torch.bfloat16)
    ref = paged.page_write_chunk(pool.clone(), table, start, vals)
    out = paged.page_write_chunk(pool.to(card), table.to(card),
                                 start.to(card), vals.to(card))
    assert torch.equal(out[:P].cpu(), ref[:P])


def test_flash_prefill_rows_without_keys_are_zero(card):
    q = torch.randn(1, 64, 2, 32, device=card).bfloat16()
    k = torch.randn(1, 64, 1, 32, device=card).bfloat16()
    qp = torch.arange(64, dtype=torch.int32, device=card)[None]
    kp = torch.where(qp >= 10, qp, -1)              # rows 0..9 see no key
    out = flash_ops.flash_prefill(q, k, k, qp, kp, causal=True, scale=0.2)
    assert bool((out[0, :10] == 0).all()) and bool(out[0, 10:].abs().sum() > 0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_prefill_skips_blocks_in_any_order(card, causal):
    """Key positions a permutation of 0..T-1 with one whole 128-key block of
    pads, query rows without a position (q_pos -1), one whole 128-row tile
    of them: block skipping assumes no order of the positions, an all-pad
    block is skipped, and rows that see no key come out zero."""
    B, S, H, KV, hd = 2, 512, 10, 2, 128
    g = torch.Generator(device=card).manual_seed(4)
    q = torch.randn(B, S, H, hd, generator=g, device=card).bfloat16()
    k = torch.randn(B, S, KV, hd, generator=g, device=card).bfloat16()
    v = torch.randn(B, S, KV, hd, generator=g, device=card).bfloat16()
    kp = torch.stack([torch.randperm(S, generator=g, device=card)
                      for _ in range(B)]).int()
    kp[:, 256:384] = -1
    qp = torch.arange(S, dtype=torch.int32, device=card).repeat(B, 1)
    qp[:, ::7] = -1
    qp[0, 128:256] = -1
    args = (q, k, v, qp, kp)
    before = flash_ops.flash_prefill.launches
    out = flash_ops.flash_prefill(*args, causal=causal, scale=hd ** -0.5)
    assert flash_ops.flash_prefill.launches == before + 1
    ref = flash_ops.flash_prefill.run_plain(*args, causal=causal,
                                            scale=hd ** -0.5)
    assert _row_err(out, ref) <= FLASH_TOL[torch.bfloat16]
    if causal:
        assert bool((out[qp < 0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale", [float("nan"), float("inf"), -float("inf")])
def test_flash_prefill_refuses_a_non_finite_scale(card, scale, dtype):
    """A NaN or infinite scale raises before either kernel is launched (the
    plain version and the reference give NaN, not a uniform mix)."""
    q = torch.randn(1, 64, 2, 64, device=card).to(dtype)
    pos = torch.arange(64, dtype=torch.int32, device=card)[None]
    before = flash_ops.flash_prefill.launches
    with pytest.raises(ValueError, match="finite"):
        flash_ops.flash_prefill(q, q, q, pos, pos, causal=True, scale=scale)
    assert flash_ops.flash_prefill.launches == before


@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_flash_prefill_bf16_takes_any_scale(card, scale):
    """The bf16 kernel folds the scale into its exp2 for scale > 0; the
    wrapper maps a negative or zero scale onto that form exactly."""
    B, S, H, KV, hd = 2, 200, 10, 2, 64
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(B, S, H, hd, generator=g, device=card).bfloat16()
    k = torch.randn(B, S, KV, hd, generator=g, device=card).bfloat16()
    v = torch.randn(B, S, KV, hd, generator=g, device=card).bfloat16()
    pos = torch.arange(S, dtype=torch.int32, device=card).repeat(B, 1)
    out = flash_ops.flash_prefill(q, k, v, pos, pos, causal=True,
                                  scale=scale)
    ref = flash_ops.flash_prefill.run_plain(q, k, v, pos, pos, causal=True,
                                            scale=scale)
    assert _row_err(out, ref) <= FLASH_TOL[torch.bfloat16]


def test_attention_kernels_refuse_what_they_do_not_take(card):
    q = torch.ones(1, 16, 2, 32, device=card, dtype=torch.float16)
    pos = torch.zeros(1, 16, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        flash_ops.flash_prefill(q, q, q, pos, pos, causal=True, scale=1.0)
    qb = torch.ones(1, 16, 2, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd in"):
        flash_ops.flash_prefill(qb, qb, qb, pos, pos, causal=True, scale=1.0)
    pool = torch.zeros(3, 4, 1, 32, device=card, dtype=torch.float16)
    ones = torch.ones(3, 4, device=card)
    table = torch.zeros(1, 2, dtype=torch.int32, device=card)
    qpos = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="pools"):
        paged_ops.paged_gqa_decode(torch.ones(1, 2, 32, device=card), pool,
                                   pool, ones, ones, table, qpos, scale=1.0)
    narrow = torch.zeros(3, 4, 1, 8, device=card, dtype=torch.uint8)
    with pytest.raises(ValueError, match="16-byte"):
        paged_ops.paged_gqa_decode(torch.ones(1, 2, 8, device=card), narrow,
                                   narrow, ones, ones, table, qpos, scale=1.0)


# (N, D, n_bits, dtype): the compressed ring's hop chunk of a DeepSeek-V3
# w1 gradient (1792 rows of 18432 at 4 ranks), the reference's parity
# shapes, ragged row counts, and the narrowest and widest codes
LOGFMT_CASES = [(1792, 18432, 8, torch.float32),
                (1792, 18432, 10, torch.float32),
                (100, 384, 8, torch.bfloat16),
                (7, 256, 10, torch.bfloat16),
                (64, 256, 10, torch.float32),
                (13, 128, 8, torch.float32),
                (64, 512, 2, torch.float32),
                (64, 512, 3, torch.bfloat16),
                (256, 1024, 16, torch.float32)]


def _logfmt_input(card, N, D, dtype):
    g = torch.Generator(device=card).manual_seed(N * 131 + D)
    x = (torch.randn(N, D, generator=g, device=card)
         * torch.randn(N, D, generator=g, device=card).exp())
    x[0, :3] = 0.0                       # exact zeros encode as code 0
    return x.to(dtype)


@pytest.mark.parametrize("case", LOGFMT_CASES)
def test_logfmt_encode_kernel_matches_plain(card, case):
    N, D, n_bits, dtype = case
    x = _logfmt_input(card, N, D, dtype)
    before = logfmt_ops.logfmt_encode.launches
    codes, mn, step = logfmt_ops.logfmt_encode(x, n_bits=n_bits)
    assert logfmt_ops.logfmt_encode.launches == before + 1
    rc, rmn, rstep = logfmt_ops.logfmt_encode.run_plain(x, n_bits=n_bits)
    assert codes.dtype == rc.dtype == (torch.uint8 if n_bits <= 8
                                       else torch.uint16)
    diff = codes.to(torch.int32) - rc.to(torch.int32)
    assert float((diff != 0).float().mean()) < 1e-3
    assert int(diff.abs().max()) <= 1
    assert bool((codes[0, :3] == 0).all())
    torch.testing.assert_close(mn, rmn, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(step, rstep, rtol=1e-5, atol=1e-5)


def _logfmt_edge_check(got, ref, structured):
    """Codes equal to the plain version's on the ``structured`` tiles (a
    bool per tile of the 2-D input), the codec's tolerance on the whole
    (one level apart on under 0.1%); mn and step within their tolerances."""
    (codes, mn, step), (rc, rmn, rstep) = got, ref
    N, D = codes.shape
    tiles = lambda c: c.to(torch.int32).reshape(N * D // 128, 128)
    keep = structured.reshape(-1)
    bad = (tiles(codes)[keep] != tiles(rc)[keep]).any(dim=1)
    assert not bool(bad.any()), (
        f"{int(bad.sum())} structured tiles differ from the plain version")
    diff = codes.to(torch.int32) - rc.to(torch.int32)
    assert float((diff != 0).float().mean()) < 1e-3
    assert int(diff.abs().max()) <= 1
    torch.testing.assert_close(mn, rmn, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(step, rstep, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_bits", [2, 3, 8, 10, 16])
def test_logfmt_encode_edge_tiles_match_plain(card, n_bits, dtype):
    """The edge tiles of ``kernels/logfmt/edge.py``: subnormals count as
    zero (inputs, grid points, differences), the range clamp, ±inf and
    NaN, and steps at the 1e-12 floor, at 2^-23 and at 1/64 of a log unit,
    which put a tile on either side of the line between the kernel's
    estimate path and its whole-tile reference arithmetic (the 1/64 tile:
    step 1.24e-4 at 8 bits, above the 2^-13 line; 3.1e-5 at 10, below)."""
    x, names = logfmt_edge.edge_tiles()
    x = torch.from_numpy(x).to(card).to(dtype)
    got = logfmt_ops.logfmt_encode(x, n_bits=n_bits)
    ref = logfmt_ops.logfmt_encode.run_plain(x, n_bits=n_bits)
    structured = torch.tensor([n in logfmt_edge.STRUCTURED for n in names],
                              device=card)
    _logfmt_edge_check(got, ref, structured[:, None])


@pytest.mark.parametrize("n_bits", [8, 10])
def test_logfmt_encode_edge_tiles_inside_the_hop_chunk(card, n_bits):
    """The edge tiles scattered over the ring's hop chunk, where each warp
    walks many tiles and loads the next before encoding this one."""
    N, D = 1792, 18432
    x = _logfmt_input(card, N, D, torch.float32)
    edge, names = logfmt_edge.edge_tiles()
    edge = torch.from_numpy(edge).to(card)
    structured = torch.zeros(N, D // 128, dtype=torch.bool, device=card)
    g = torch.Generator(device="cpu").manual_seed(n_bits)
    spots = torch.randperm(N * D // 128, generator=g)[:40 * len(names)]
    for j, t in enumerate(spots.tolist()):
        r, c = divmod(t, D // 128)
        x[r, c * 128:(c + 1) * 128] = edge[j % len(names)]
        structured[r, c] = names[j % len(names)] in logfmt_edge.STRUCTURED
    got = logfmt_ops.logfmt_encode(x, n_bits=n_bits)
    ref = logfmt_ops.logfmt_encode.run_plain(x, n_bits=n_bits)
    _logfmt_edge_check(got, ref, structured)


@pytest.mark.parametrize("n_bits", [3, 8, 10, 16])
def test_logfmt_encode_grid_points_and_midpoints_match_plain(card, n_bits):
    """Tiles whose values sit on their own grid points and on the linear
    midpoints between neighbours (and one ulp either side): the values the
    kernel's estimate leaves open, settled by the reference's comparison,
    and its ties. Each tile holds its least and greatest value at positions
    0 and 1, so its mn and step are those of those two alone. Codes equal
    to the plain version's."""
    T, levels = 512, 2 ** (n_bits - 1) - 1
    g = torch.Generator(device=card).manual_seed(n_bits)
    lo = torch.exp(torch.rand(T, 1, generator=g, device=card) * 12 - 9)
    hi = lo * torch.exp(torch.rand(T, 1, generator=g, device=card) * 8 + 0.5)
    ends = torch.cat([lo, hi, lo.expand(T, 126)], dim=1)
    _, mn, step = logfmt_ops.logfmt_encode.run_plain(ends, n_bits=n_bits)
    k = torch.randint(1, max(levels - 2, 2), (T, 126), generator=g,
                      device=card).float()
    point = lambda k: torch.exp(mn + step * k)
    a, b = point(k), point(k + 1)
    mid = (a + b) / 2
    pick = torch.randint(0, 4, (T, 126), generator=g, device=card)
    inner = torch.where(pick == 0, a, torch.where(
        pick == 1, mid, torch.nextafter(
            mid, torch.where(pick == 2, b, a))))
    sign = torch.where(torch.rand(T, 126, generator=g, device=card) < 0.5,
                       -1.0, 1.0)
    x = torch.cat([lo, hi, sign * inner], dim=1).reshape(T // 4, 512)
    got = logfmt_ops.logfmt_encode(x, n_bits=n_bits)
    ref = logfmt_ops.logfmt_encode.run_plain(x, n_bits=n_bits)
    torch.testing.assert_close(ref[1].reshape(-1), mn.reshape(-1), rtol=0,
                               atol=0)
    _logfmt_edge_check(got, ref, torch.ones(T // 4, 4, dtype=torch.bool,
                                            device=card))


def test_logfmt_encode_logf_is_monotone(card):
    """The encode kernel takes a tile's min and max of the logs as the logs
    of its min and max |x|: the reference's wherever its logf never
    decreases. Every pair of neighbouring positive normal floats."""
    assert logfmt_ops.logf_sweep(card) == 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        logfmt_ops.logf_sweep(card, 5, 5)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LOGFMT_CASES)
def test_logfmt_decode_kernel_matches_plain(card, case, out_dtype):
    N, D, n_bits, dtype = case
    codes, mn, step = logfmt_ops.logfmt_encode.run_plain(
        _logfmt_input(card, N, D, dtype), n_bits=n_bits)
    before = logfmt_ops.logfmt_decode.launches
    y = logfmt_ops.logfmt_decode(codes, mn, step, n_bits=n_bits,
                                 dtype=out_dtype)
    assert logfmt_ops.logfmt_decode.launches == before + 1
    ref = logfmt_ops.logfmt_decode.run_plain(codes, mn, step, n_bits=n_bits,
                                             dtype=out_dtype)
    assert y.dtype == out_dtype and y.shape == (N, D)
    tol = (dict(rtol=1e-4, atol=1e-5) if out_dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    torch.testing.assert_close(y.float(), ref.float(), **tol)


def test_logfmt_ops_reshape_a_batched_input_on_the_card(card):
    x = _logfmt_input(card, 6, 256, torch.float32).reshape(2, 3, 256)
    codes, mn, step = logfmt_ops.logfmt_encode(x, n_bits=8)
    assert codes.shape == (2, 3, 256) and mn.shape == step.shape == (2, 3, 2)
    y = logfmt_ops.logfmt_decode(codes, mn, step, n_bits=8,
                                 dtype=torch.float32)
    ref = logfmt_ops.logfmt_decode.run_plain(
        *logfmt_ops.logfmt_encode.run_plain(x, n_bits=8), n_bits=8,
        dtype=torch.float32)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-5)


def test_logfmt_kernels_refuse_what_they_do_not_take(card):
    with pytest.raises(ValueError, match="multiple of 128"):
        logfmt_ops.logfmt_encode(torch.ones(4, 200, device=card), n_bits=8)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        logfmt_ops.logfmt_encode(torch.ones(4, 128, device=card,
                                            dtype=torch.float16), n_bits=8)
    with pytest.raises(ValueError, match="2-16 bits"):
        logfmt_ops.logfmt_encode(torch.ones(4, 128, device=card), n_bits=17)
    codes, mn, step = logfmt_ops.logfmt_encode(
        torch.ones(4, 128, device=card), n_bits=8)
    with pytest.raises(TypeError, match="codes are"):
        logfmt_ops.logfmt_decode(codes, mn, step, n_bits=10)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        logfmt_ops.logfmt_decode(codes, mn, step, n_bits=8,
                                 dtype=torch.float16)
    with pytest.raises(ValueError, match="multiple of 128"):
        logfmt_ops.logfmt_decode(codes[:, :100], mn, step, n_bits=8)
    with pytest.raises(ValueError, match="mn and step"):
        logfmt_ops.logfmt_decode(codes, mn[:2], step, n_bits=8)


# each served path: the model, its overrides of the smoke config (qwen3-14b
# keeps 5 query heads per KV head, as at full width), the engine's layout
# options, the kernels its path must launch and those it must not
ENGINE_PATHS = {
    "deepseek-v3-671b": ("deepseek-v3-671b", {}, dict(paged=True),
                         {"fp8_gemm", "moe_gemm", "paged_mla_decode"}, set()),
    "qwen3-14b": ("qwen3-14b", dict(num_heads=10, num_kv_heads=2),
                  dict(paged=True), {"flash_prefill", "paged_gqa_decode"},
                  set()),
    "deepseek-v3-671b-dense": ("deepseek-v3-671b", {},
                               dict(paged=False, use_mtp=True),
                               {"fp8_gemm", "moe_gemm", "mla_decode"},
                               {"paged_mla_decode"}),
    # the published query heads per KV head at head_dim 32; the MoE archs'
    # bf16 experts reach moe_gemm, and nothing fp8_gemm
    "glm4-9b": ("glm4-9b", dict(num_heads=32, num_kv_heads=2),
                dict(paged=True), {"flash_prefill", "paged_gqa_decode"},
                {"fp8_gemm", "moe_gemm"}),
    "qwen1.5-4b": ("qwen1.5-4b", {}, dict(paged=True),
                   {"flash_prefill", "paged_gqa_decode"},
                   {"fp8_gemm", "moe_gemm"}),
    "yi-34b": ("yi-34b", dict(num_heads=14, num_kv_heads=2),
               dict(paged=True), {"flash_prefill", "paged_gqa_decode"},
               {"fp8_gemm", "moe_gemm"}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b",
                          dict(num_heads=16, num_kv_heads=2),
                          dict(paged=True),
                          {"flash_prefill", "paged_gqa_decode", "moe_gemm"},
                          {"fp8_gemm"}),
    "llama4-maverick-400b-a17b": (
        "llama4-maverick-400b-a17b", dict(num_heads=10, num_kv_heads=2),
        dict(paged=True), {"flash_prefill", "paged_gqa_decode", "moe_gemm"},
        {"fp8_gemm"}),
    # the recurrent families on the dense engine (no paged layout): no op
    # of the registry lies on their path; recurrentgemma at 5 layers runs
    # its rg_tail too
    "mamba2-2.7b": ("mamba2-2.7b", {}, dict(paged=False), set(),
                    set(registry.names())),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, dict(paged=False), set(),
                          set(registry.names())),
    "recurrentgemma-9b-5": ("recurrentgemma-9b", dict(num_layers=5),
                            dict(paged=False), set(), set(registry.names())),
}


@pytest.mark.parametrize("path", sorted(ENGINE_PATHS))
def test_engine_on_the_card_launches_every_kernel(card, path):
    arch, overrides, layout, kernels, not_kernels = ENGINE_PATHS[path]
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="bfloat16", param_dtype="bfloat16",
                              fp8_impl="pallas", **overrides)
    eng = ServeEngine(cfg, slots=2, max_len=32, chunk=4, page_size=8,
                      page_storage="fp8", attn_impl="pallas", device=card,
                      **layout)
    reqs = [Request(i, np.arange(4 + i), max_new=5) for i in range(3)]
    registry.reset_launch_counts()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    counts = registry.launch_counts()
    assert all(counts[n] > 0 for n in kernels), counts
    assert not any(counts[n] for n in not_kernels), counts
    if eng.paged:
        assert eng.free_pages() == eng.pool_pages
    if eng.use_mtp:
        assert eng.stats["drafts"] == 12        # 3 requests x 4 decode steps


def _engine_run(cfg, layout, sampling, params=None, eager=False):
    """Three requests on two slots of a smoke-width engine (the third
    admitted mid-run into a freed slot), each with its sampling seed; the
    decode chunk graphed (the card's default) or, through the engine's
    private seam, eager. Returns (engine, streams, launch counts)."""
    eng = ServeEngine(cfg, params=params, slots=2, max_len=32, chunk=4,
                      page_size=8, page_storage="fp8", attn_impl="pallas",
                      device="cuda", **layout, **sampling)
    eng._decode.graphed = not eager
    reqs = [Request(i, np.arange(4 + 3 * i) * (i + 2) % cfg.vocab_size,
                    max_new=n, seed=100 + i)
            for i, n in enumerate((5, 11, 8))]
    registry.reset_launch_counts()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return eng, [r.out for r in reqs], registry.launch_counts()


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.8, top_k=20)],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("path", sorted(ENGINE_PATHS))
def test_graphed_engine_equals_the_eager_chunk(card, path, sampling):
    """The decode chunk captured once and replayed every tick gives the
    eager chunk's streams (greedy, and seeded temperature/top-k draws), MTP
    counts and launch counts (the capture's tally times its replays), on
    the same weights."""
    arch, overrides, layout, kernels, _ = ENGINE_PATHS[path]
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="bfloat16", param_dtype="bfloat16",
                              fp8_impl="pallas", **overrides)
    eng, streams, counts = _engine_run(cfg, layout, sampling)
    ref, ref_streams, ref_counts = _engine_run(cfg, layout, sampling,
                                               params=eng.params, eager=True)
    assert eng.trace_counts == {"decode": 1, "chunk": 0}
    assert ref.trace_counts == {"decode": 0, "chunk": 0}
    assert streams == ref_streams
    assert counts == ref_counts and all(counts[n] > 0 for n in kernels)
    assert set(eng._decode.tally) == set(kernels) - {"flash_prefill"}
    assert (eng.stats["drafts"], eng.stats["accepted_drafts"]) == (
        ref.stats["drafts"], ref.stats["accepted_drafts"])
    if eng.use_mtp:
        assert eng.stats["drafts"] > 0


def _chunked_run(cfg, params=None, eager=False):
    """A smoke-width qwen3-14b engine with chunked prefill (chunk 8, page 8,
    fp8 pages): a first request of one chunk graduates in the first tick
    (the eager first run of both graphs) and decodes; a second admits in
    the second tick, whose prefill chunk is captured while the first
    decodes and whose decode chunk is captured while the second is
    mid-prefill, and graduates after both captures; then a third shares
    the second one's prefix. Both chunks graphed or, through the private
    seams, eager. Returns (engine, streams, whether the prefill chunk was
    captured while a slot decoded, whether the decode chunk was captured
    while a slot prefilled)."""
    eng = ServeEngine(cfg, params=params, slots=2, max_len=64, chunk=4,
                      paged=True, page_size=8, page_storage="fp8",
                      prefill_chunk=8, attn_impl="pallas", device="cuda")
    eng._decode.graphed = eng._prefill.graphed = not eager
    rng = np.random.default_rng(21)
    prefix = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    prompts = [rng.integers(1, cfg.vocab_size, 6)] + [
        np.concatenate([prefix, rng.integers(1, cfg.vocab_size, n)])
        for n in (26, 9)]
    news = (40, 10, 10)
    reqs = [Request(i, p, max_new=m, seed=i)
            for i, (p, m) in enumerate(zip(prompts, news))]
    eng.submit(reqs[0])
    eng.step()
    assert reqs[0].out and eng._decode.calls == eng._prefill.calls == 1
    eng.submit(reqs[1])
    eng.step()
    chunk_mid_decode = (eng._prefill.calls == 2 and eng._decode.calls == 2
                        and not reqs[0].done)
    decode_mid_prefill = bool(eng._prefilling)
    while not reqs[1].done:
        eng.step()
    eng.submit(reqs[2])
    eng.run_until_done()
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert eng.free_pages() == eng.pool_pages
    return (eng, [r.out for r in reqs], chunk_mid_decode,
            decode_mid_prefill)


def test_chunked_engine_graph_equals_the_eager_chunk(card):
    """The prefill chunk captured while a slot decodes, the decode chunk
    captured while a slot is mid-prefill, graduating after it: its row
    reaches the decode replays through the in-place install, the chunk
    graph's page writes reach them through the shared pool, and every
    stream equals the eager chunks'."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-14b")),
                              dtype="bfloat16", param_dtype="bfloat16",
                              num_heads=10, num_kv_heads=2)
    eng, streams, chunk_mid, decode_mid = _chunked_run(cfg)
    ref, ref_streams, _, _ = _chunked_run(cfg, params=eng.params, eager=True)
    assert chunk_mid and decode_mid
    assert eng.trace_counts == {"decode": 1, "chunk": 1}
    assert ref.trace_counts == {"decode": 0, "chunk": 0}
    assert streams == ref_streams
    assert eng.stats["chunk_prefills"] == ref.stats["chunk_prefills"] > 2
    assert eng.prefix_stats()["hits"] > 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b"])
def test_replayed_prefill_chunk_equals_the_eager_chunk(card, arch):
    """A prompt of five chunks through the engine's chunk graph (the first
    chunk eager, the second captured and replayed, the rest replays) and
    through eager chunks on the same weights: every chunk's logits, every
    page of every pool (the trash page aside) and ``mtp_h`` bit for bit.
    A shared page may come from either, so they must agree."""
    over = (dict(num_heads=10, num_kv_heads=2) if arch == "qwen3-14b"
            else {})
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="bfloat16", param_dtype="bfloat16",
                              fp8_impl="pallas", **over)
    kw = dict(slots=2, max_len=64, chunk=4, paged=True, page_size=8,
              prefill_chunk=8, attn_impl="pallas", device=card)
    eng = ServeEngine(cfg, **kw)
    ref = ServeEngine(cfg, params=eng.params, **kw)
    ref._prefill.graphed = False
    rng = np.random.default_rng(23)
    L = 37
    prompt = rng.integers(1, cfg.vocab_size, L).astype(np.int32)
    row = np.full((8,), eng.pool_pages, np.int32)
    row[:5] = [7, 2, 11, 0, 5]
    for start in range(0, L, 8):
        toks = np.zeros((8,), np.int32)
        toks[:min(L, start + 8) - start] = prompt[start:start + 8]
        a = eng._prefill(toks, start, L, 1, row).clone()
        b = ref._prefill(toks, start, L, 1, row).clone()
        assert torch.isfinite(a).all() and torch.equal(a, b), start
    assert eng.trace_counts["chunk"] == 1 and ref.trace_counts["chunk"] == 0
    for seg in eng.model.segments:
        for n, t in eng.cache[seg.name].items():
            assert torch.equal(t[:, :-1], ref.cache[seg.name][n][:, :-1]), n
    if "mtp_h" in eng.cache:
        assert eng.cache["mtp_h"][1].any()
        assert torch.equal(eng.cache["mtp_h"], ref.cache["mtp_h"])


def test_prefix_sharing_on_the_card_equals_a_cold_engine(card):
    """Shared prefix pages hold the bytes a recomputation writes: each
    request's stream on the sharing engine equals its stream alone on a
    fresh engine (bitwise, on the card's kernels). One prompt is exactly
    the indexed prefix, so its last chunk re-runs over shared pages while
    the resident that wrote them decodes: those pages keep their bytes."""
    cfg = dataclasses.replace(smoke_config(get_config("deepseek-v3-671b")),
                              dtype="bfloat16", param_dtype="bfloat16",
                              fp8_impl="pallas")
    eng = ServeEngine(cfg, slots=3, max_len=64, chunk=4, paged=True,
                      page_size=8, prefill_chunk=8, attn_impl="pallas",
                      device=card)
    rng = np.random.default_rng(22)
    prefix = rng.integers(1, cfg.vocab_size, 24).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, cfg.vocab_size, n)])
               for n in (3, 11, 6)] + [prefix]
    news = [24, 8, 8, 8]
    reqs = [Request(i, p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, news))]
    eng.submit(reqs[0])
    for _ in range(4):
        eng.step()
    shared = eng._slot_pages[0][:3]

    def pages():
        return [eng.cache[g][n][:, shared].clone()
                for g in ("dense0", "blocks") for n in eng.cache[g]]

    before = pages()
    eng.submit(reqs[3])                  # one chunk, over the third page
    eng.step()
    assert eng.stats["chunk_prefills"] == 5 and eng.prefix_stats()["hits"] == 3
    assert reqs[3].out and not reqs[0].done
    assert all(torch.equal(a, b) for a, b in zip(pages(), before))
    for r in reqs[1:3]:
        eng.submit(r)
        for _ in range(4):
            eng.step()
    eng.run_until_done()
    assert eng.prefix_stats()["hits"] > 3
    for r, p, m in zip(reqs, prompts, news):
        cold = ServeEngine(cfg, params=eng.params, slots=3, max_len=64,
                           chunk=4, paged=True, page_size=8, prefill_chunk=8,
                           attn_impl="pallas", device=card)
        alone = Request(r.rid, p, max_new=m)
        cold.submit(alone)
        cold.run_until_done()
        assert alone.out == r.out


def _tree_equal(a, b):
    la, lb = paged.payload_leaves(a), paged.payload_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def _wide_dsv3():
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    # no capacity drops: a request's stream does not depend on which
    # others share its decode steps, so a tiered run can equal an untiered
    return dataclasses.replace(
        cfg, dtype="bfloat16", param_dtype="bfloat16", fp8_impl="pallas",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def test_spill_fetch_resume_round_trip_on_a_graphed_engine(card):
    """Suspensions and resumes between replays of both captured graphs:
    each fetch installs the spilled bytes exactly (pages read back equal
    the host copy), each resume writes the slot's ``mtp_h`` and MTP ring
    rows back as they were at suspend, no cache leaf is rebound, both
    graphs are captured once, and every stream equals an untiered twin's
    on the same weights."""
    from repro_torch.serve import tier
    from repro_torch.serve.engine import _slot_slice
    cfg = _wide_dsv3()
    kw = dict(slots=2, max_len=64, chunk=4, paged=True, page_size=8,
              page_storage="fp8", prefill_chunk=8, attn_impl="pallas",
              device=card)
    eng = ServeEngine(cfg, pool_pages=16, host_tier_pages=48,
                      tier_config=tier.TierConfig(quantum=4), **kw)
    twin = ServeEngine(cfg, params=eng.params, **kw)
    checks = {"fetch": 0, "aux": 0}
    finish, install = eng._finish_fetch, eng._install_slot

    def finish_fetch(t):
        e = eng._suspended.get(t.rid)
        ent = e["tier_entry"] if e else None
        finish(t)
        if ent is not None and e["state"] == "ready":
            back = tier.staged_get(eng.model.gather_pages(eng.cache,
                                                          e["pages"]))
            assert _tree_equal(back, ent.payload)
            checks["fetch"] += 1

    def install_slot(slot, pages, aux):
        install(slot, pages, aux)
        back = tier.staged_get(_slot_slice(eng.cache, slot, eng._axes))
        assert aux and _tree_equal(back, aux)
        checks["aux"] += 1

    eng._finish_fetch, eng._install_slot = finish_fetch, install_slot

    def ptrs(tree):
        if isinstance(tree, dict):
            return {k: ptrs(v) for k, v in tree.items()}
        return tree.data_ptr()

    before = ptrs(eng.cache)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, 9 + i).astype(np.int32)
               for i in range(6)]
    runs = []
    for e in (eng, twin):
        reqs = [Request(i, p, max_new=24, seed=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        e.run_until_done()
        assert all(r.done for r in reqs)
        runs.append([r.out for r in reqs])
    ts = eng.tier_stats()
    assert ts["suspensions"] > 0 and ts["resumes"] == ts["suspensions"]
    assert checks["fetch"] == ts["resumes"] and checks["aux"] >= ts["resumes"]
    assert ts["crc_failures"] == 0 and ts["degraded"] == 0
    assert eng.trace_counts == {"decode": 1, "chunk": 1}
    assert ptrs(eng.cache) == before
    assert eng.free_pages() == eng.pool_pages and eng.tier.entries() == 0
    assert runs[0] == runs[1]


def test_a_prefix_fetch_lands_before_the_captured_chunk_reads_it(card):
    """Warm prefix pages harvested to the host tier come back into fresh
    pages through a staged copy and an in-place scatter queued before the
    replayed prefill chunk that reads them: the repeat's stream equals the
    same request alone on a cold untiered engine, bit for bit."""
    from repro_torch.serve import tier
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-14b")),
                              dtype="bfloat16", param_dtype="bfloat16",
                              num_heads=10, num_kv_heads=2)
    kw = dict(slots=2, max_len=64, chunk=4, paged=True, page_size=8,
              page_storage="fp8", pool_pages=12, prefill_chunk=8,
              attn_impl="pallas", device=card)
    eng = ServeEngine(cfg, host_tier_pages=24,
                      tier_config=tier.TierConfig(quantum=4), **kw)
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    prompt_a = np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 5)])
    prompt_b = np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 7)])
    fillers = [rng.integers(1, cfg.vocab_size, 17 + i).astype(np.int32)
               for i in range(4)]
    work = [Request(0, prompt_a, max_new=8, seed=9)] + [
        Request(10 + i, p, max_new=8, seed=20 + i)
        for i, p in enumerate(fillers)]
    for r in work[:1] + work[1:]:
        eng.submit(r)
        eng.run_until_done()
    assert eng.tstats["prefix_spilled"] >= 2
    assert eng.trace_counts == {"decode": 1, "chunk": 1}
    repeat = Request(99, prompt_b, max_new=8, seed=3)
    eng.submit(repeat)
    eng.run_until_done()
    assert eng.tstats["prefix_fetched"] >= 2
    cold = ServeEngine(cfg, params=eng.params, **kw)
    alone = Request(99, prompt_b, max_new=8, seed=3)
    cold.submit(alone)
    cold.run_until_done()
    assert repeat.done and repeat.out == alone.out
    assert eng.trace_counts == {"decode": 1, "chunk": 1}


def test_gateway_replicas_share_the_expert_codes(card):
    """Two gateway replicas on one parameter set: the second engine gets
    the first's prepared weights, the same E4M3 expert codes (one
    data_ptr), and both serve."""
    from repro_torch.serve.gateway import Gateway
    cfg = _wide_dsv3()
    gw = Gateway(cfg, replicas=2, slots=2, max_len=64, chunk=4, paged=True,
                 page_size=8, prefill_chunk=8, attn_impl="pallas",
                 device=card)
    a, b = (r.engine.params for r in gw.registry.replicas.values())
    wa, wb = a["blocks"]["moe"]["w1"], b["blocks"]["moe"]["w1"]
    assert isinstance(wa, fp8.Fp8Experts)
    assert wa.wq.data_ptr() == wb.wq.data_ptr()
    reqs = [gw.submit(np.arange(4) + 10 * i, max_new=6) for i in range(4)]
    gw.run_until_done()
    assert all(r.state == "done" and len(r.delivered) == 6 for r in reqs)
    assert {r.replica for r in reqs} == {0, 1}


def test_a_host_read_under_capture_raises(card, monkeypatch):
    """A host read on the decode path is fine in the eager first chunk and
    fails the capture of the second: ``step()`` raises, and keeps raising,
    instead of decoding eagerly. (Last in this file: the failed capture
    leaves its stream's pool behind.)"""
    from repro_torch.models import api
    sample = api.sample_logits

    def reading(logits, *a, **k):
        float(logits.sum())                  # waits on the card
        return sample(logits, *a, **k)

    monkeypatch.setattr(api, "sample_logits", reading)
    cfg = dataclasses.replace(smoke_config(get_config("deepseek-v3-671b")),
                              dtype="bfloat16", param_dtype="bfloat16",
                              fp8_impl="pallas")
    eng = ServeEngine(cfg, slots=2, max_len=32, chunk=4, paged=True,
                      page_size=8, attn_impl="pallas", device=card)
    req = Request(0, np.arange(6), max_new=16)
    eng.submit(req)
    eng.step()
    n = len(req.out)
    assert n == 5                             # prefill's token + 4 eager
    for _ in range(2):
        with pytest.raises(RuntimeError):
            eng.step()
    assert len(req.out) == n and eng.trace_counts == {"decode": 0,
                                                      "chunk": 0}


# the families with a memory at smoke width, bf16: seamless on paged fp8
# pages (its decoder's self-attention through flash_prefill and
# paged_gqa_decode; the encoder and the cross-attention on the plain path,
# as the reference's), the vision family on the dense engine (flash_prefill
# for its self blocks; dense decode has no kernel). Each request carries
# seeded frames (fewer than the 16-row memory leaf at max_len 64) or
# patches; the vision gates are drawn non-zero.
MEMORY_PATHS = {
    "seamless-m4t-large-v2": (dict(paged=True),
                              {"flash_prefill", "paged_gqa_decode"}),
    "llama-3.2-vision-90b": (dict(paged=False), {"flash_prefill"}),
}


def _memory_run(arch, params=None, eager=False):
    layout, _ = MEMORY_PATHS[arch]
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="bfloat16", param_dtype="bfloat16")
    eng = ServeEngine(cfg, params=params, slots=2, max_len=64, chunk=4,
                      page_size=8, page_storage="fp8", attn_impl="pallas",
                      device="cuda", **layout)
    if params is None and cfg.family == "vlm":
        g = torch.Generator(device="cuda").manual_seed(3)
        for k in ("gate_attn", "gate_mlp"):
            gate = eng.params["pat"]["cross"][k]
            gate.copy_(torch.randn(gate.shape, generator=g, device="cuda"))
    eng._decode.graphed = not eager
    ptrs = {k: t.data_ptr() for k, t in
            ((k, v) for k, v in eng.cache.items() if torch.is_tensor(v))}
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, 5 + 4 * i),
                    max_new=n) for i, n in enumerate((5, 11, 8))]
    rows = (6, 13, 16) if cfg.family == "encdec" else (cfg.num_patches,) * 3
    key = "src_embeds" if cfg.family == "encdec" else "patch_embeds"
    registry.reset_launch_counts()
    for r, n in zip(reqs, rows):
        eng.submit(r, {key: torch.from_numpy(rng.normal(
            size=(1, n, cfg.d_model)).astype(np.float32)).bfloat16()})
    eng.run_until_done()
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert ptrs == {k: t.data_ptr() for k, t in eng.cache.items()
                    if torch.is_tensor(t)}
    return eng, [r.out for r in reqs], registry.launch_counts()


@pytest.mark.parametrize("arch", sorted(MEMORY_PATHS))
def test_memory_engines_graph_equals_the_eager_chunk(card, arch):
    """Each family with a memory serves with its extras through the decode
    graph (captured once, reading the memory leaf admission writes in
    place) and gives the eager chunk's streams and launch counts; its
    kernels launch and no other; no page leaks."""
    eng, streams, counts = _memory_run(arch)
    ref, ref_streams, ref_counts = _memory_run(arch, params=eng.params,
                                               eager=True)
    _, kernels = MEMORY_PATHS[arch]
    assert eng.trace_counts == {"decode": 1, "chunk": 0}
    assert streams == ref_streams and counts == ref_counts
    assert {n for n, c in counts.items() if c} == kernels
    if eng.paged:
        assert eng.free_pages() == eng.pool_pages
