"""The engine's decode chunk as one CUDA graph — the port's counterpart of
the reference's jitted chunk (``src/repro/serve/engine.py``:
``jax.jit(decode_chunk, donate_argnums=(1, 2))``, traced once and
dispatched once a tick).

Eagerly, a chunk of ``k`` decode steps issues every op from Python: about
a thousand kernels a DeepSeek-V3 step and five thousand a qwen3-14b step,
each behind its host-side dispatch. Here the chunk is captured once and
then replayed: one launch a tick, the card's time the kernels' own.

A :class:`DecodeChunk` is fixed for its engine: model, weights, cache,
slots, ``k``, sampling and MTP. Its I/O is static:

* input: one int64 ``(7, slots)`` buffer on the card, the rows
  :data:`STATE_ROWS`, filled each tick by one non-blocking copy from a
  pinned host tensor;
* output: one int32 ``(slots, 2k + 7)`` tensor — the chunk's tokens, its
  emitted mask, then the slot state (:data:`OUT_ROWS`) and the chunk's
  draft counters — copied back into a pinned host tensor, after which
  the tick synchronises once.

Both formats stay inside this module: a caller passes the slots' state
by name and gets the chunk's results back by name.

The captured region slices that buffer into the state ``decode_loop``
takes (the chunk's MTP counters zeroed), runs ``Model.decode_loop``
unchanged and packs its results into the output tensor. The cache is
written in place (the model rebinds no leaf), so admissions and releases
between replays write straight into the buffers the graph reads.

The first chunk runs eagerly on the chunk's own stream: it is real work,
and it warms what must not first happen under capture (kernel builds and
loads, the C entries' static attribute set-up, cuBLAS handles and
workspaces, the cached SM count). The second call captures, inside a
launch :func:`registry.tally`, and replays at once, since a capture
executes nothing; every replay adds the tally to the launch counters. On
the card a failed capture or replay raises: the chunk never carries on
eagerly. On the CPU there is no graph, and the same function runs
eagerly each call.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import registry

# the rows of the input buffer, in order
STATE_ROWS = ("tokens", "positions", "active", "left", "eos", "tix", "seeds")
# the columns of the output after the chunk's tokens and emitted mask: the
# slot state after the chunk, then the chunk's MTP counters
OUT_ROWS = ("tokens", "positions", "active", "left", "tix", "drafts",
            "accepted")


class DecodeChunk:
    """``k`` fused decode steps over an engine's slots: captured once as a
    CUDA graph on the card, eager on the CPU. ``graphed`` is decided by
    the device; the card's tests and ``chip_smoke.py`` clear it to run the
    same chunk eagerly as their oracle."""

    def __init__(self, model, params, cache, slots: int, k: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 use_mtp: bool = False):
        self.model, self.params, self.cache = model, params, cache
        self.k = k
        self.sampling = dict(temperature=temperature, top_k=top_k,
                             use_mtp=use_mtp)
        dev = model.device
        self.graphed = dev.type == "cuda"
        self.state = torch.zeros((len(STATE_ROWS), slots), dtype=torch.int64,
                                 device=dev)
        self._staging = torch.zeros(self.state.shape, dtype=torch.int64,
                                    pin_memory=self.graphed)
        self._host = torch.zeros((slots, 2 * k + len(OUT_ROWS)),
                                 dtype=torch.int32, pin_memory=self.graphed)
        self._stream: Optional[torch.cuda.Stream] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self.tally: Dict[str, int] = {}     # kernel launches of one replay
        self.captures = 0
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0                 # device memory the capture took

    def _body(self) -> torch.Tensor:
        """The captured region: input buffer -> state -> ``decode_loop`` ->
        one packed output tensor."""
        rows = dict(zip(STATE_ROWS, self.state))
        zero = torch.zeros((), dtype=torch.int32, device=self.state.device)
        state = {n: rows[n].int() for n in STATE_ROWS
                 if n not in ("active", "seeds")}
        state.update(active=rows["active"] > 0, seeds=rows["seeds"],
                     drafts=zero, accepted=zero.clone())
        toks, emitted, _, st = self.model.decode_loop(
            self.params, self.cache, state, self.k, **self.sampling)
        B = toks.shape[0]
        cols = [st[n].int().expand(B) for n in OUT_ROWS]
        return torch.cat([toks, emitted.int(), torch.stack(cols, dim=1)],
                         dim=1)

    def __call__(self, state: Dict[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        """Run one chunk from the slots' state on the host (``(slots,)``
        arrays named by :data:`STATE_ROWS`). Returns the chunk's tokens
        ``(slots, k)`` (-1 where a slot was inactive), its emitted mask
        ``(slots, k)`` and the columns named by :data:`OUT_ROWS`, each
        ``(slots,)`` (the MTP counters repeated per slot)."""
        staging = self._staging.numpy()
        for i, name in enumerate(STATE_ROWS):
            staging[i] = state[name]
        self.state.copy_(self._staging, non_blocking=True)
        if not self.graphed:
            out = self._body()
        elif self._graph is not None:
            self._graph.replay()
            registry.add_launches(self.tally, 1)
            out = self._out
        else:
            out = self._warm_or_capture()
        self._host.copy_(out, non_blocking=True)
        if self.state.is_cuda:
            torch.cuda.current_stream(self.state.device).synchronize()
        host = self._host.numpy().copy()
        k = self.k
        return (host[:, :k], host[:, k:2 * k].astype(bool),
                dict(zip(OUT_ROWS, host[:, 2 * k:].T.copy())))

    def _warm_or_capture(self) -> torch.Tensor:
        """The first call runs the chunk eagerly on the capture stream; the
        second captures it there and replays it once."""
        dev = self.state.device
        cur = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                out = self._body()
            cur.wait_stream(self._stream)
            return out
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with registry.tally() as tally, torch.cuda.graph(
                graph, stream=self._stream):
            out = self._body()
        t1 = time.perf_counter()
        graph.instantiate()
        self.capture_s = t1 - t0
        self.instantiate_s = time.perf_counter() - t1
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._graph, self._out, self.tally = graph, out, tally
        self.captures += 1
        graph.replay()
        registry.add_launches(tally, 1)
        return out
