"""Inference speed-limit model (paper §2.3.2) + all-to-all bandwidth model
(paper Figures 5–7) + MFU accounting (paper Table 4) — a copy of
``repro.network.perfmodel`` (standard library only).

§2.3.2 TPOT roofline: per MoE layer, dual-microbatch overlap makes the EP
dispatch (FP8, 1 B) + combine (BF16, 2 B) all-to-all the critical path:

  comm_time = (1 + 2) bytes * batch_per_device * fanout * hidden / bw
  TPOT      = layers * 2 * comm_time          (two a2a phases per layer)

Paper numbers reproduced exactly: 14.76 ms (50 GB/s IB) -> 67 tok/s and
0.82 ms (GB200 900 GB/s) -> ~1200 tok/s. The node-limited variant
(``h800_ib_node_limited``) plugs M (<= 4) deduplicated sends instead of
the paper's 9 (8 routed + shared) and keeps the shared expert local
(fanout M, not M+1). Every bandwidth here is the paper's, not a
measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class EPSpeedLimit:
    name: str
    bandwidth: float           # B/s effective per device
    layers: int = 61
    batch_per_device: int = 32
    hidden: int = 7168         # "~7K" in the paper
    fanout: float = 9          # 8 routed + 1 shared (paper's accounting)
    dispatch_bytes: float = 1  # FP8
    combine_bytes: float = 2   # BF16

    @property
    def comm_time_s(self) -> float:
        return ((self.dispatch_bytes + self.combine_bytes)
                * self.batch_per_device * self.fanout * self.hidden
                / self.bandwidth)

    @property
    def layer_time_s(self) -> float:
        return 2.0 * self.comm_time_s      # dual micro-batch: 2 phases

    @property
    def tpot_s(self) -> float:
        return self.layers * self.layer_time_s

    @property
    def tokens_per_s(self) -> float:
        return 1.0 / self.tpot_s


def paper_h800_ib() -> EPSpeedLimit:
    """Paper: (1+2) * 32 * 9 * 7K / 50GB/s = 120.96 us -> 14.76 ms TPOT."""
    return EPSpeedLimit("CX7-400G-IB", 50e9, hidden=7000)


def paper_gb200() -> EPSpeedLimit:
    """Paper: 900 GB/s -> 6.72 us -> ~0.82 ms TPOT (~1200 tok/s)."""
    return EPSpeedLimit("GB200-NVL72", 900e9, hidden=7000)


def h800_ib_node_limited(dedup: bool = True) -> EPSpeedLimit:
    """The node-limited comparison on the paper's own fabric (50 GB/s
    CX7 InfiniBand, hidden 7168): dedup caps the fanout at M = 4 nodes and
    the shared expert stays local; without it each token makes its 8
    routed sends. It stands in for the reference's ``tpu_v5e_ici``, the
    same comparison mapped onto another accelerator's links, whose figures
    this package does not carry."""
    return EPSpeedLimit("CX7-400G-IB" + ("-dedup" if dedup else ""),
                        50e9, fanout=4 if dedup else 8, hidden=7168)


# ---------------------------------------------------------------------------
# All-to-all bandwidth model (Figures 5-7): effective per-GPU bandwidth as
# message size grows — latency term + bandwidth term (alpha-beta model).
# ---------------------------------------------------------------------------


def alltoall_busbw(msg_bytes: float, devices: int, link_bw: float = 50e9,
                   latency_us: float = 3.6) -> float:
    """Effective per-device all-to-all bus bandwidth (B/s)."""
    t = latency_us * 1e-6 + msg_bytes * (devices - 1) / devices / link_bw
    return msg_bytes / t


# ---------------------------------------------------------------------------
# Table 4-style MFU accounting
# ---------------------------------------------------------------------------


def mfu(tokens_per_step: float, step_time_s: float, n_active: float,
        seq_len: int, n_layers: int, n_heads: int, head_dim: int,
        peak_flops: float, causal: bool = True) -> Dict[str, float]:
    """MFU per the paper's Table 4 conventions: causal counts the lower
    triangle of attention (FlashAttention convention), non-causal the full
    matrix (Megatron convention)."""
    gemm = 6.0 * n_active * tokens_per_step
    attn_full = 12.0 * tokens_per_step * seq_len * n_layers * n_heads \
        * head_dim
    flops_causal = gemm + attn_full / 2
    flops_noncausal = gemm + attn_full
    return {
        "tflops_causal": flops_causal / step_time_s / 1e12,
        "tflops_noncausal": flops_noncausal / step_time_s / 1e12,
        "mfu_causal": flops_causal / step_time_s / peak_flops,
        "mfu_noncausal": flops_noncausal / step_time_s / peak_flops,
    }
