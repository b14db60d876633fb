"""The engine's two jitted entry points as CUDA graphs — the port's
counterpart of the reference's ``jax.jit(decode_chunk)`` and
``jax.jit(chunk_prefill)`` (``src/repro/serve/engine.py``), each traced
once and dispatched once a tick.

Eagerly, a chunk issues every op from Python: about a thousand kernels a
DeepSeek-V3 decode step and five thousand a qwen3-14b step or prefill
chunk, each behind its host-side dispatch. Here each chunk is captured
once and then replayed: one launch a tick, the card's time the kernels'
own.

* :class:`DecodeChunk`: ``k`` fused decode steps over every slot. Input:
  one int64 ``(7, slots)`` buffer, the rows :data:`STATE_ROWS`. Output:
  one int32 ``(slots, 2k + 7)`` tensor — the chunk's tokens, its emitted
  mask, then the slot state (:data:`OUT_ROWS`) and the chunk's draft
  counters — copied back into a pinned host tensor, after which the tick
  synchronises once.
* :class:`PrefillChunk`: one page-aligned chunk of ``C`` tokens of one
  slot's prompt (``Model.prefill_chunk``). Input: one int32 buffer of the
  chunk's tokens and positions, the prompt's length, the slot and its
  page-table row. Output: the ``(1, 1, V)`` logits at the chunk's last
  real position, which the caller reads only after a prompt's last chunk.
  A chunk neither reads back nor waits: its operands cross in one
  non-blocking copy from pinned memory.

Both formats stay inside this module: a caller passes values by name and
gets results back by name. Each graph is fixed for its engine (model,
weights, cache, shapes, sampling), and the cache is written in place (the
model rebinds no leaf), so the chunk graph's page writes, admissions and
releases between replays all write straight into the buffers the other
graph reads; so does an admission's splice of the enc-dec or vision
memory into its slot's rows of the ``memory`` leaf, which every replay
reads. Both graphs replay on the caller's current stream, in the
order the engine issues them.

The first call of each runs eagerly on its own stream, which waits for
the caller's stream and is waited for by it: it is real work, and it
warms what must not first happen under capture (kernel builds and loads,
the C entries' static attribute set-up, cuBLAS handles and workspaces,
the cached SM count). The second call captures, inside a launch
:func:`registry.tally`, and replays at once, since a capture executes
nothing; every replay adds the tally to the launch counters. On the card
a failed capture or replay raises: a chunk never carries on eagerly. On
the CPU there is no graph, and the same function runs eagerly each call.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import registry

# the rows of the decode chunk's input buffer, in order
STATE_ROWS = ("tokens", "positions", "active", "left", "eos", "tix", "seeds")
# the columns of the output after the chunk's tokens and emitted mask: the
# slot state after the chunk, then the chunk's MTP counters
OUT_ROWS = ("tokens", "positions", "active", "left", "tix", "drafts",
            "accepted")


class _Graphed:
    """A function of one static input buffer, run eagerly once on its own
    stream, then captured and replayed (module docstring). Subclasses set
    ``self.input`` and define :meth:`_body`; :meth:`_run` returns the
    body's output, a static tensor once captured. ``graphed`` is decided
    by the device; the card's tests and ``chip_smoke.py`` clear it to run
    the same chunk eagerly as their oracle."""

    def __init__(self, device: torch.device):
        self.graphed = device.type == "cuda"
        self._stream: Optional[torch.cuda.Stream] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self.tally: Dict[str, int] = {}     # kernel launches of one replay
        self.calls = 0                      # chunks run
        self.captures = 0
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0                 # device memory the capture took

    def _body(self) -> torch.Tensor:
        raise NotImplementedError

    def _run(self) -> torch.Tensor:
        self.calls += 1
        if not self.graphed:
            return self._body()
        if self._graph is not None:
            self._graph.replay()
            registry.add_launches(self.tally, 1)
            return self._out
        return self._warm_or_capture()

    def _warm_or_capture(self) -> torch.Tensor:
        """The first call runs the body eagerly on the capture stream; the
        second captures it there and replays it once."""
        dev = self.input.device
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


class DecodeChunk(_Graphed):
    """``k`` fused decode steps over an engine's slots: captured once as a
    CUDA graph on the card, eager on the CPU."""

    def __init__(self, model, params, cache, slots: int, k: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 use_mtp: bool = False, overlap: bool = False, pctx=None,
                 batch_sharded: bool = False):
        super().__init__(model.device)
        self.model, self.params, self.cache = model, params, cache
        self.k = k
        # overlap: the dual-microbatch loop; pctx / batch_sharded: one mesh
        # rank's slots (``decode_loop``)
        self.sampling = dict(temperature=temperature, top_k=top_k,
                             use_mtp=use_mtp, overlap=overlap, pctx=pctx,
                             batch_sharded=batch_sharded)
        self.input = torch.zeros((len(STATE_ROWS), slots),
                                 dtype=torch.int64, device=model.device)
        self._staging = torch.zeros(self.input.shape, dtype=torch.int64,
                                    pin_memory=self.graphed)
        self._host = torch.zeros((slots, 2 * k + len(OUT_ROWS)),
                                 dtype=torch.int32, pin_memory=self.graphed)

    def _body(self) -> torch.Tensor:
        """The captured region: input buffer -> state -> ``decode_loop`` ->
        one packed output tensor."""
        rows = dict(zip(STATE_ROWS, self.input))
        zero = torch.zeros((), dtype=torch.int32, device=self.input.device)
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
        self.input.copy_(self._staging, non_blocking=True)
        out = self._run()
        self._host.copy_(out, non_blocking=True)
        if self.input.is_cuda:
            torch.cuda.current_stream(self.input.device).synchronize()
        host = self._host.numpy().copy()
        k = self.k
        return (host[:, :k], host[:, k:2 * k].astype(bool),
                dict(zip(OUT_ROWS, host[:, 2 * k:].T.copy())))


class PrefillChunk(_Graphed):
    """One chunk of ``C`` tokens of one slot's prompt into the engine's
    paged cache (``Model.prefill_chunk``): captured once as a CUDA graph
    on the card, eager on the CPU. Every chunk of every prompt and slot
    has the same shapes; the slot and its page-table row are operands, so
    one graph serves them all. ``pctx``: one mesh rank's chunk, as
    :class:`DecodeChunk`'s (run eagerly: the caller clears ``graphed``)."""

    def __init__(self, model, params, cache, C: int, pages_per_slot: int,
                 pctx=None):
        super().__init__(model.device)
        self.model, self.params, self.cache = model, params, cache
        self.C = C
        self.pctx = pctx
        # the fields of the input buffer: tokens and positions (C,), the
        # prompt's length and the slot (1,), the row (pages_per_slot,)
        self._fields = dict(tokens=slice(0, C), positions=slice(C, 2 * C),
                            length=slice(2 * C, 2 * C + 1),
                            slot=slice(2 * C + 1, 2 * C + 2),
                            row=slice(2 * C + 2, 2 * C + 2 + pages_per_slot))
        self.input = torch.zeros((2 * C + 2 + pages_per_slot,),
                                 dtype=torch.int32, device=model.device)

    @property
    def row(self) -> torch.Tensor:
        """The last chunk's page-table row on the device: the engine
        installs it at graduation with a copy ordered after the chunk."""
        return self.input[self._fields["row"]]

    def _body(self) -> torch.Tensor:
        f = {n: self.input[s] for n, s in self._fields.items()}
        logits, _ = self.model.prefill_chunk(
            self.params, self.cache, f["tokens"][None], f["positions"][None],
            f["length"], f["row"][None], f["slot"], pctx=self.pctx)
        return logits

    def __call__(self, tokens: np.ndarray, start: int, length: int,
                 slot: int, row: np.ndarray) -> torch.Tensor:
        """Run the chunk of ``tokens`` (``(C,)``, pads past the prompt) at
        positions ``[start, start + C)`` of a prompt of ``length`` tokens,
        for ``slot`` with page-table ``row``. Returns the logits ``(1, 1,
        V)`` at the chunk's last real position: on the card a static
        buffer, valid until the next call."""
        f = self._fields
        ops = np.empty(self.input.shape, np.int32)
        ops[f["tokens"]] = tokens
        ops[f["positions"]] = np.arange(start, start + self.C)
        ops[f["length"]] = length
        ops[f["slot"]] = slot
        ops[f["row"]] = row
        host = torch.from_numpy(ops)
        if self.graphed:
            # pinned through the caching host allocator, which keeps the
            # block until the copy has run: the host does not wait
            host = host.pin_memory()
        self.input.copy_(host, non_blocking=True)
        return self._run()
