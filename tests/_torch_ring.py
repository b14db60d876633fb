"""Rank body of ``tests/test_torch_collectives.py``: the port's
``compressed_psum`` on gloo ranks on the CPU.

It imports torch, numpy and the port only, so a spawned rank starts
without JAX. Each rank reads the members' inputs from ``inputs.npz``,
runs every case and writes its results to ``rank<r>.npz``.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

# case -> (group layout, n_bits, dtype): "world" is the 4-rank ring,
# "pairs" two 2-rank rings ([0, 1] and [2, 3]), "single" a ring of one
CASES = {
    "gauss_10bit": ("world", 10, "float32"),
    "f32_10bit": ("world", 10, "float32"),
    "ragged_8bit": ("world", 8, "float32"),
    "bf16_8bit": ("world", 8, "bfloat16"),
    "pairs_8bit": ("pairs", 8, "float32"),
    "single_8bit": ("single", 8, "float32"),
}


def run_rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    from repro_torch.parallel.collectives import compressed_psum
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    # every rank creates every group, in the same order
    groups = {"world": None,
              "pairs": [dist.new_group([0, 1]), dist.new_group([2, 3])],
              "single": [dist.new_group([r]) for r in range(world)]}
    pick = {"world": lambda g: g, "pairs": lambda g: g[rank // 2],
            "single": lambda g: g[rank]}
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    out = {}
    for name, (layout, n_bits, dtype) in CASES.items():
        x = torch.from_numpy(inputs[name][rank]).to(getattr(torch, dtype))
        y = compressed_psum(x, group=pick[layout](groups[layout]),
                            n_bits=n_bits)
        assert y.dtype == x.dtype and y.shape == x.shape, (name, y.dtype)
        out[name] = y.float().numpy()
        out[name + ":same_object"] = np.array(y is x)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
