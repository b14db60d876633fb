"""Fault-tolerant multi-replica serving gateway — port of
``repro.serve.gateway``.

Millions of users means many engines, not one. The paper frames DeepSeek-V3-class serving as a datacenter systems problem —
multi-replica, SLO-driven (Ma & Patterson, PAPERS.md) — and its §6.1
reliability discussion (node crashes, hangs, stragglers) applies to the
serving tier as much as to training. This module is the tier around the
engines:

* **ReplicaRegistry** — register/deregister in-process ``ServeEngine``
  replicas, all sharing one parameter set: the first engine prepares it,
  and every later replica gets the same prepared tensors, which
  ``bridge.prepare_for_serving`` returns as they are, so N replicas hold
  one copy of the weights and each adds only its cache and its graphs; tick-driven heartbeats drive the health
  state machine HEALTHY→SUSPECT→DEAD (``suspect_after`` /
  ``dead_after`` missed beats), with per-replica load + free-page
  occupancy piggybacked on each beat.
* **Router** — least-loaded routing over routable replicas (healthy or
  merely suspect, circuit not open), with a prefix-hash **affinity
  hook** (same prompt prefix re-routes to the replica that served it, as
  long as its load is within ``affinity_slack`` of the least-loaded —
  the paged cache makes prefix reuse a real win) and a per-replica
  **circuit breaker**: ``circuit_threshold`` consecutive dispatch
  failures open the circuit, ``circuit_cooldown`` ticks later a single
  half-open probe decides between closing it and re-opening.
* **Request lifecycle** — per-request deadline (ticks) and wall-clock
  timeout, bounded gateway queue with typed ``AdmissionError``
  backpressure, and **idempotent retry**: when a replica dies
  mid-decode, every resident request is re-dispatched on a survivor as a
  *continuation* — re-prefill ``prompt + delivered`` with
  ``sample_offset=len(delivered)`` — and because sampling keys are a
  pure function of (request seed, stream index), greedy/seeded outputs
  are **bitwise identical** to the no-fault run (pinned by the chaos
  suite).
* **Graceful degradation** — priority load shedding once pool occupancy
  crosses ``shed_watermark`` (queued requests below
  ``shed_min_priority`` are rejected; the default of 0 sheds only
  traffic explicitly marked sub-zero priority — raise it to make
  default traffic sheddable under pressure), and a **drain mode** that
  finishes residents while refusing new admits.

Faults are injected by ``serve/fault.py`` (``crash:<r>``, ``hang:<r>``,
``slow:<r>``, ``flaky-admit:<r>``, and the KV-tier kinds
``pcie_slow:<r>`` / ``pcie_drop:<r>`` / ``tier_full``, which reach each
replica's engine through a clock-shared ``TierFaultAdapter``) on the
same tick clock, so every path above is exercised deterministically by
the tests and by ``chip_smoke.py``.

The gateway is tick-driven: ``tick()`` advances the virtual clock one
scheduling round (heartbeats → deadlines → shed → route → step →
collect). A tick is the gateway's unit of time everywhere — deadlines,
cooldowns, TTFT — which makes chaos runs bit-reproducible; wall-clock
per-request timeouts are layered on top for real deployments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.engine import AdmissionError, Request, ServeEngine
from repro_torch.serve.fault import (ReplicaCrash, ServeFaultInjector,
                                     TierFaultAdapter)

# Health states (registry) and circuit states (router), as plain strings
# so they serialize straight into stats/bench rows.
HEALTHY, SUSPECT, DEAD = "healthy", "suspect", "dead"
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

# Terminal gateway-request states.
QUEUED, RUNNING, DONE = "queued", "running", "done"
FAILED, SHED, TIMED_OUT = "failed", "shed", "timed_out"


@dataclasses.dataclass
class GatewayRequest:
    """One client request as the gateway sees it.

    ``delivered`` is the token stream already synced back to the gateway
    (what the client has); on a replica death mid-decode it is exactly
    the durable prefix a retry continues from. ``seed`` defaults to the
    request id so every request is retry-reproducible unless the caller
    opts out with an explicit seed.
    """

    gid: int
    prompt: np.ndarray
    max_new: int = 16
    eos: Optional[int] = None
    seed: Optional[int] = None
    priority: int = 0                 # higher survives shedding
    deadline: Optional[int] = None    # absolute tick; None = no deadline
    wall_timeout_s: Optional[float] = None
    state: str = QUEUED
    delivered: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    replica: Optional[int] = None     # current assignment
    submitted_tick: int = 0
    first_token_tick: Optional[int] = None
    finished_tick: Optional[int] = None
    submitted_wall: float = 0.0
    error: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.state in (DONE, FAILED, SHED, TIMED_OUT)


@dataclasses.dataclass
class Replica:
    """Registry handle for one engine replica: health + circuit state and
    the load report piggybacked on its last heartbeat."""

    rid: int
    engine: ServeEngine
    state: str = HEALTHY
    missed_beats: int = 0
    last_beat: int = 0
    # circuit breaker
    circuit: str = CLOSED
    failures: int = 0                 # consecutive dispatch failures
    opened_at: int = 0
    probe_gid: Optional[int] = None   # in-flight half-open probe
    capacity: int = 1 << 30           # decode slots (set at register);
                                      # the router never dispatches past
                                      # it — backpressure pools at the
                                      # gateway where routing can still
                                      # change its mind
    # last heartbeat's load report
    load: int = 0
    occupancy: float = 0.0
    free_pages: int = 0
    prefix_hit_rate: float = 0.0
    indexed_pages: int = 0
    # host KV tier: how full the replica's second memory level
    # is and how many requests are parked there — capacity planning sees
    # the whole hierarchy, not just HBM
    host_occupancy: float = 0.0
    host_free_pages: int = 0
    tier_suspended: int = 0

    def report(self):
        """Refresh the load report (called on each heartbeat)."""
        eng = self.engine
        busy = sum(r is not None for r in eng.active)
        self.load = busy + len(eng.pending)
        slot_occ = busy / eng.slots if eng.slots else 0.0
        if eng.paged:
            self.occupancy = max(slot_occ, eng.pool_stats()["occupancy"])
            self.free_pages = eng.free_pages()
            ps = eng.prefix_stats()
            self.prefix_hit_rate = ps["hit_rate"]
            self.indexed_pages = ps["indexed_pages"]
        else:
            self.occupancy = slot_occ
            self.free_pages = 0
        if eng.tier is not None:
            ts = eng.tier_stats()
            self.host_occupancy = ts["host_occupancy"]
            self.host_free_pages = ts["host_pages_free"]
            self.tier_suspended = ts["suspended"]
            # tier-suspended requests are the replica's to finish: count
            # them as load so the router doesn't pile new work onto a
            # replica whose pool is already time-slicing
            self.load += ts["suspended"]


class ReplicaRegistry:
    """Replica pool membership + the heartbeat-driven health machine.

    ``beat(tick, alive)`` is called once per gateway tick per replica:
    a missed beat increments the counter, ``suspect_after`` misses mark
    SUSPECT (still routable — could be a GC pause), ``dead_after``
    misses mark DEAD (terminal: residents are retried elsewhere, the
    handle only leaves the table on ``deregister``)."""

    def __init__(self, suspect_after: int = 2, dead_after: int = 4):
        if not 0 < suspect_after < dead_after:
            raise ValueError("need 0 < suspect_after < dead_after, got "
                             f"{suspect_after} / {dead_after}")
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.replicas: Dict[int, Replica] = {}
        self._next_rid = 0

    def register(self, engine: ServeEngine) -> Replica:
        rep = Replica(self._next_rid, engine, capacity=engine.slots)
        self.replicas[rep.rid] = rep
        self._next_rid += 1
        return rep

    def deregister(self, rid: int) -> None:
        self.replicas.pop(rid, None)

    def beat(self, rep: Replica, tick: int, alive: bool) -> None:
        """Process one heartbeat window for ``rep`` at ``tick``."""
        if rep.state == DEAD:
            return
        if alive:
            rep.missed_beats = 0
            rep.last_beat = tick
            if rep.state == SUSPECT:
                rep.state = HEALTHY
            rep.report()
            return
        rep.missed_beats += 1
        if rep.missed_beats >= self.dead_after:
            rep.state = DEAD
        elif rep.missed_beats >= self.suspect_after:
            rep.state = SUSPECT

    def mark_dead(self, rep: Replica) -> None:
        rep.state = DEAD

    def live(self) -> List[Replica]:
        return [r for r in self.replicas.values() if r.state != DEAD]

    def states(self) -> Dict[int, str]:
        return {rid: r.state for rid, r in self.replicas.items()}


class Router:
    """Least-loaded routing with a prefix-affinity hook and per-replica
    circuit breakers.

    Routable = not DEAD, circuit not OPEN (an OPEN circuit turns
    HALF_OPEN after ``cooldown`` ticks and then admits exactly one probe
    request; the probe's fate closes or re-opens it). SUSPECT replicas
    stay routable — the breaker, not the health machine, guards against
    a replica that accepts work and fails it."""

    def __init__(self, threshold: int = 3, cooldown: int = 6,
                 affinity_prefix: int = 8, affinity_slack: int = 2,
                 cache_threshold: float = 0.9):
        self.threshold = threshold
        self.cooldown = cooldown
        self.affinity_prefix = affinity_prefix
        self.affinity_slack = affinity_slack
        # cache-aware cutoff: above this pool occupancy the affine
        # replica's prefix pages are at eviction risk and admission may
        # block on pages, so the router stops honoring affinity and falls
        # back to least-loaded (the sglang-style cache_threshold policy,
        # fed by the occupancy each heartbeat piggybacks)
        self.cache_threshold = cache_threshold
        self.affinity_hits = 0
        self._affinity: Dict[int, int] = {}    # prefix hash -> replica id

    def _prefix_hash(self, prompt: np.ndarray) -> int:
        return hash(tuple(int(t) for t in prompt[:self.affinity_prefix]))

    def routable(self, reps: List[Replica], tick: int) -> List[Replica]:
        out = []
        for r in reps:
            if r.state == DEAD or r.load >= r.capacity:
                continue
            if r.circuit == OPEN:
                if tick - r.opened_at >= self.cooldown:
                    r.circuit = HALF_OPEN
                    r.probe_gid = None
                else:
                    continue
            if r.circuit == HALF_OPEN and r.probe_gid is not None:
                continue                        # one probe at a time
            out.append(r)
        return out

    def route(self, gr: GatewayRequest, reps: List[Replica],
              tick: int) -> Optional[Replica]:
        """Pick a replica for ``gr`` (None = nothing routable). Prefers
        the prefix-affinity replica when its load is within
        ``affinity_slack`` of the least-loaded candidate and its pool
        occupancy is below ``cache_threshold`` (a saturated pool would
        not hold the prefix pages anyway)."""
        cands = self.routable(reps, tick)
        if not cands:
            return None
        best = min(cands, key=lambda r: (r.load, r.rid))
        key = self._prefix_hash(gr.prompt)
        aff_rid = self._affinity.get(key)
        pick = best
        if aff_rid is not None:
            aff = next((r for r in cands if r.rid == aff_rid), None)
            if aff is not None and aff.load <= best.load + \
                    self.affinity_slack and \
                    aff.occupancy < self.cache_threshold:
                pick = aff
                self.affinity_hits += 1
        self._affinity[key] = pick.rid
        if pick.circuit == HALF_OPEN:
            pick.probe_gid = gr.gid
        return pick

    def on_success(self, rep: Replica) -> None:
        rep.failures = 0
        if rep.circuit != CLOSED:
            rep.circuit = CLOSED
            rep.probe_gid = None

    def on_failure(self, rep: Replica, tick: int) -> None:
        rep.failures += 1
        if rep.circuit == HALF_OPEN or rep.failures >= self.threshold:
            rep.circuit = OPEN
            rep.opened_at = tick
            rep.probe_gid = None


class Gateway:
    """The serving tier: N in-process engine replicas sharing one
    parameter set behind a health-checked, retrying, load-shedding
    front door. See the module docstring for the component map.

    ``attn_impl`` and ``device`` go to every replica's engine, as the
    engine takes them. The gateway catches ``ReplicaCrash`` and
    ``AdmissionError`` alone: any other error of an engine (a CUDA fault,
    a failed kernel build or graph capture) propagates to the caller, and
    is never taken for a dead replica and retried on a survivor."""

    def __init__(self, cfg: ModelConfig, params=None, replicas: int = 2,
                 slots: int = 4, max_len: int = 128, seed: int = 0,
                 chunk: int = 8, temperature: float = 0.0, top_k: int = 0,
                 paged: bool = False, page_size: int = 8,
                 pool_pages: Optional[int] = None,
                 page_storage: str = "fp8",
                 prefill_chunk: Optional[int] = None,
                 host_tier_pages: Optional[int] = None,
                 tier_config=None,
                 max_pending: int = 64,
                 engine_max_pending: Optional[int] = 8,
                 suspect_after: int = 2, dead_after: int = 4,
                 circuit_threshold: int = 3, circuit_cooldown: int = 6,
                 cache_threshold: float = 0.9,
                 shed_watermark: float = 0.9, shed_min_priority: int = 0,
                 max_retries: int = 2,
                 injector: Optional[ServeFaultInjector] = None,
                 attn_impl: str = "", device=None):
        if replicas < 1:
            raise ValueError("need at least one replica")
        self.cfg = cfg
        self.registry = ReplicaRegistry(suspect_after, dead_after)
        self.router = Router(circuit_threshold, circuit_cooldown,
                             cache_threshold=cache_threshold)
        self.injector = injector
        self.max_pending = max_pending
        self.shed_watermark = shed_watermark
        self.shed_min_priority = shed_min_priority
        self.max_retries = max_retries
        self.clock = 0
        self.draining = False
        self.queue: List[GatewayRequest] = []
        self.requests: Dict[int, GatewayRequest] = {}
        self._next_gid = 0
        self._next_engine_rid = 0
        self._dead_handled: set = set()
        # engine request handles per assignment: gid -> (Request, consumed)
        self._engine_reqs: Dict[int, Tuple[Request, int]] = {}
        self.stats = {"submitted": 0, "completed": 0, "retries": 0,
                      "shed": 0, "timed_out": 0, "rejected": 0,
                      "failed": 0, "replica_deaths": 0, "ticks": 0,
                      "dispatches": 0, "affinity_hits": 0}
        for i in range(replicas):
            # tier faults ride the gateway clock: each replica's engine
            # consults its own adapter, so ``pcie_slow:<r>`` degrades one
            # replica's link while its peers transfer at full speed
            tf = None
            if injector is not None and host_tier_pages is not None:
                tf = TierFaultAdapter(injector, replica=i,
                                      clock=lambda: self.clock)
            eng = ServeEngine(cfg, params=params, slots=slots,
                              max_len=max_len, seed=seed + i, chunk=chunk,
                              temperature=temperature, top_k=top_k,
                              paged=paged, page_size=page_size,
                              pool_pages=pool_pages,
                              page_storage=page_storage,
                              prefill_chunk=prefill_chunk,
                              host_tier_pages=host_tier_pages,
                              tier_config=tier_config,
                              tier_faults=tf,
                              max_pending=engine_max_pending,
                              attn_impl=attn_impl, device=device)
            if params is None:
                params = eng.params       # one parameter set, N replicas
            self.registry.register(eng)
        self.params = params

    # -- intake -----------------------------------------------------------
    def submit(self, prompt, max_new: int = 16, eos: Optional[int] = None,
               seed: Optional[int] = None, priority: int = 0,
               timeout_ticks: Optional[int] = None,
               wall_timeout_s: Optional[float] = None) -> GatewayRequest:
        """Accept a request into the gateway queue.

        Raises ``AdmissionError`` (backpressure) when draining or when
        the bounded queue is full — the caller retries elsewhere/later,
        nothing is silently dropped. ``seed`` defaults to the request id
        so retries are reproducible by default."""
        if self.draining:
            raise AdmissionError("gateway is draining: refusing new "
                                 "admissions (residents finish first)")
        if len(self.queue) >= self.max_pending:
            self.stats["rejected"] += 1
            raise AdmissionError(
                f"gateway queue full: {len(self.queue)} >= max_pending "
                f"({self.max_pending}) — backpressure, retry later")
        gr = GatewayRequest(
            gid=self._next_gid, prompt=np.asarray(prompt, np.int32),
            max_new=max_new, eos=eos,
            seed=self._next_gid if seed is None else seed,
            priority=priority,
            deadline=(None if timeout_ticks is None
                      else self.clock + timeout_ticks),
            wall_timeout_s=wall_timeout_s,
            submitted_tick=self.clock, submitted_wall=time.monotonic())
        self._next_gid += 1
        self.requests[gr.gid] = gr
        self.queue.append(gr)
        self.stats["submitted"] += 1
        return gr

    def drain(self) -> None:
        """Enter drain mode: finish every resident/queued request, refuse
        new admissions (``submit`` raises)."""
        self.draining = True

    # -- pool introspection ----------------------------------------------
    def pool_occupancy(self) -> float:
        """Busy fraction of the live pool (max of slot and page
        occupancy), the shedding watermark input."""
        live = self.registry.live()
        if not live:
            return 1.0
        for r in live:
            r.report()
        return sum(r.occupancy for r in live) / len(live)

    # -- fault plumbing ---------------------------------------------------
    def _alive(self, rep: Replica) -> bool:
        inj = self.injector
        return inj is None or inj.heartbeats(rep.rid)

    def _kill(self, rep: Replica) -> None:
        """Handle a replica death: mark DEAD and retry its residents.
        Idempotent via its own marker — the heartbeat path may already
        have flipped the state to DEAD before this runs."""
        if rep.rid in self._dead_handled:
            return
        self._dead_handled.add(rep.rid)
        self.registry.mark_dead(rep)
        rep.circuit = OPEN            # a dead replica's circuit is open
        rep.opened_at = self.clock    # by definition; never half-opens
        self.stats["replica_deaths"] += 1
        for gr in list(self.requests.values()):
            if gr.state == RUNNING and gr.replica == rep.rid:
                self._retry(gr)

    def _retry(self, gr: GatewayRequest) -> None:
        """Re-dispatch ``gr`` as a continuation of its delivered prefix.

        The dead replica's un-synced tail is gone (correctly — the
        client never saw it); the retry re-prefills prompt + delivered
        with ``sample_offset=len(delivered)``, so the seeded sampling
        stream continues exactly where the delivered prefix ended."""
        self._engine_reqs.pop(gr.gid, None)
        gr.replica = None
        if len(gr.delivered) >= gr.max_new:
            # everything durable was already delivered: the replica died
            # between the last token and the done flag — nothing to redo
            gr.state = DONE
            gr.finished_tick = self.clock
            self.stats["completed"] += 1
            return
        if gr.retries >= self.max_retries:
            gr.state = FAILED
            gr.error = "retry budget exhausted"
            gr.finished_tick = self.clock
            self.stats["failed"] += 1
            return
        gr.retries += 1
        self.stats["retries"] += 1
        gr.state = QUEUED
        self.queue.insert(0, gr)      # retries go to the head: they have
                                      # already waited their turn once

    # -- the scheduling round --------------------------------------------
    def tick(self) -> None:
        """One scheduling round on the virtual clock: advance injected
        faults, heartbeat the pool, enforce deadlines, shed over the
        watermark, route the queue, drive the engines, collect tokens."""
        self.clock += 1
        self.stats["ticks"] += 1
        if self.injector is not None:
            self.injector.advance(self.clock)
        # 1. heartbeats -> health machine; fresh deaths retry residents
        for rep in list(self.registry.replicas.values()):
            was = rep.state
            self.registry.beat(rep, self.clock, self._alive(rep))
            if rep.state == DEAD and was != DEAD:
                self._kill(rep)
        # 1b. a fully-dead pool can never make progress: fail what's left
        #     loudly instead of spinning forever
        if not self.registry.live():
            for gr in list(self.requests.values()):
                if not gr.done:
                    gr.state = FAILED
                    gr.error = "no live replicas"
                    gr.finished_tick = self.clock
                    self.stats["failed"] += 1
            self.queue = []
            return
        # 2. deadlines / wall-clock timeouts
        now = time.monotonic()
        for gr in list(self.requests.values()):
            if gr.done:
                continue
            tick_out = gr.deadline is not None and self.clock > gr.deadline
            wall_out = (gr.wall_timeout_s is not None
                        and now - gr.submitted_wall > gr.wall_timeout_s)
            if tick_out or wall_out:
                self._timeout(gr)
        # 3. load shedding at the occupancy watermark
        if self.queue and self.pool_occupancy() >= self.shed_watermark:
            keep = []
            for gr in self.queue:
                if gr.priority >= self.shed_min_priority:
                    keep.append(gr)
                else:
                    gr.state = SHED
                    gr.error = "shed at occupancy watermark"
                    gr.finished_tick = self.clock
                    self.stats["shed"] += 1
            self.queue = keep
        # 4. route queued requests to replicas
        self._dispatch_queue()
        # 5. drive the engines (skip dead/hung; slow replicas step less
        #    often — a straggler makes progress, just late)
        for rep in self.registry.live():
            self._step_replica(rep)
        # 6. collect delivered tokens
        self._collect()
        self.stats["affinity_hits"] = self.router.affinity_hits

    def _timeout(self, gr: GatewayRequest) -> None:
        if gr.state == RUNNING and gr.replica is not None:
            rep = self.registry.replicas.get(gr.replica)
            handle = self._engine_reqs.pop(gr.gid, None)
            # only talk to the engine if the replica is actually there —
            # a crashed/dead one gets cleaned up by _kill instead
            if (rep is not None and rep.state != DEAD
                    and handle is not None
                    and (self.injector is None
                         or not self.injector.crashed(rep.rid))):
                rep.engine.cancel(handle[0].rid)
        if gr in self.queue:
            self.queue.remove(gr)
        gr.state = TIMED_OUT
        gr.error = "deadline exceeded"
        gr.finished_tick = self.clock
        self.stats["timed_out"] += 1

    def _dispatch_queue(self) -> None:
        """Route as much of the queue as the pool will take. A dispatch
        failure feeds the circuit breaker; a crash marks the replica dead
        (and retries its residents) without losing the request."""
        reps = list(self.registry.replicas.values())
        # snapshot: a dispatch-time crash retries residents by inserting
        # at self.queue's head, which must not perturb this iteration
        work, self.queue = self.queue, []
        remaining: List[GatewayRequest] = []
        for gr in work:
            if gr.done:
                continue
            rep = self.router.route(gr, reps, self.clock)
            if rep is None:
                remaining.append(gr)
                continue
            if not self._dispatch(gr, rep):
                remaining.append(gr)
        self.queue = self.queue + remaining

    def _dispatch(self, gr: GatewayRequest, rep: Replica) -> bool:
        """Hand ``gr`` to ``rep``'s engine as a continuation of its
        delivered prefix. True on success."""
        inj = self.injector
        prompt = (np.concatenate([gr.prompt,
                                  np.asarray(gr.delivered, np.int32)])
                  if gr.delivered else gr.prompt)
        ereq = Request(self._next_engine_rid, prompt.astype(np.int32),
                       max_new=gr.max_new - len(gr.delivered), eos=gr.eos,
                       seed=gr.seed, sample_offset=len(gr.delivered),
                       priority=gr.priority)
        try:
            if inj is not None:
                inj.check_alive(rep.rid)
                if inj.admit_fails(rep.rid, self.clock):
                    raise AdmissionError(
                        f"replica {rep.rid}: injected flaky admission")
            rep.engine.submit(ereq)
        except ReplicaCrash:
            self._kill(rep)
            return False
        except AdmissionError:
            self.router.on_failure(rep, self.clock)
            return False
        self._next_engine_rid += 1
        self.router.on_success(rep)
        self.stats["dispatches"] += 1
        gr.state = RUNNING
        gr.replica = rep.rid
        rep.load += 1               # optimistic until the next heartbeat
        self._engine_reqs[gr.gid] = (ereq, 0)
        return True

    def _step_replica(self, rep: Replica) -> bool:
        """Drive one engine tick for ``rep``; False = no progress."""
        inj = self.injector
        if inj is not None:
            if inj.hung(rep.rid):
                return False             # wedged: no progress, no error
            mult = inj.slow_multiplier(rep.rid, self.clock)
            if mult > 1.0 and self.clock % int(mult) != 0:
                return False             # straggler: steps every mult-th
            try:
                inj.check_alive(rep.rid)
            except ReplicaCrash:
                self._kill(rep)
                return False
        # has_work, not pending/active: a tiered engine whose requests
        # are all suspended in the host tier looks idle by the old test
        # but still owes them fetches and resumes
        if not rep.engine.has_work():
            return False
        rep.engine.step()
        return True

    def _collect(self) -> None:
        """Sync newly generated tokens from engine requests into their
        gateway requests' delivered streams."""
        for gid, (ereq, consumed) in list(self._engine_reqs.items()):
            gr = self.requests[gid]
            rep = self.registry.replicas.get(gr.replica)
            if rep is None or rep.state == DEAD:
                continue                 # handled by _kill/_retry
            if self.injector is not None and (
                    self.injector.crashed(rep.rid)
                    or self.injector.hung(rep.rid)):
                continue                 # nothing durable comes back
            fresh = ereq.out[consumed:]
            if fresh:
                if gr.first_token_tick is None:
                    gr.first_token_tick = self.clock
                gr.delivered.extend(fresh)
                self._engine_reqs[gid] = (ereq, len(ereq.out))
            if ereq.done:
                del self._engine_reqs[gid]
                gr.state = DONE
                gr.finished_tick = self.clock
                self.stats["completed"] += 1

    # -- drivers ----------------------------------------------------------
    def outstanding(self) -> int:
        return sum(not gr.done for gr in self.requests.values())

    def run_until_done(self, max_ticks: int = 1000) -> None:
        """Drive ticks until every accepted request reaches a terminal
        state (completed, failed, shed, or timed out)."""
        for _ in range(max_ticks):
            if not self.outstanding():
                return
            self.tick()
        raise RuntimeError(
            f"gateway did not converge in {max_ticks} ticks: "
            f"{self.outstanding()} requests outstanding "
            f"(states {self.registry.states()})")
