"""PyTorch port: the fault-spec grammar (``faultspec.py``), the serve-side
fault injector (``serve/fault.py``) and the multi-replica gateway
(``serve/gateway.py``) against the JAX package, as
``tests/test_faultspec.py``, ``tests/test_serve_gateway.py`` and the
gateway cases of ``tests/test_kv_tier.py`` run them.

The grammar, the injector and the router take the same calls on both
packages and must give the same answers. Each gateway scenario runs once
on the JAX gateway (its registry's ``ref`` backend, once per module) and
once on the port's, two replicas on the same weights
(``bridge.params_from_jax``), and the two must agree exactly: every
request's delivered stream, state and retries, the gateway's counters,
each replica's health, circuit and load report, and each replica engine's
``stats`` (but ``dispatches``), ``tier_stats()``, ``pool_stats()`` and
``prefix_stats()`` — under each fault kind: ``crash``, ``hang``,
``slow``, ``flaky-admit`` on dense engines (smoke qwen3-14b, as
``test_serve_gateway.py``), ``pcie_slow``, ``pcie_drop`` and
``tier_full`` on paged engines with a host tier (as ``test_kv_tier.py``).
Sampled streams are held against the port's own fault-free run.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import faultspec as jfaultspec
from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.models.api import Model as JModel
from repro.serve import fault as jfault
from repro.serve import gateway as jgateway
from repro.serve import tier as jtier
from repro_torch import bridge, faultspec
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.serve import fault, gateway, tier
from repro_torch.serve.engine import AdmissionError
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def qwen():
    cfg = smoke_config(get_config("qwen3-14b"))
    jp = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jp, tsmoke(tget("qwen3-14b")), tp


# ---------------------------------------------------------------------------
# faultspec, the injector and the router: the same calls, the same answers
# ---------------------------------------------------------------------------


def _parse(mod, fn, *args):
    try:
        got = getattr(mod, fn)(*args)
    except ValueError as e:
        return "ValueError", str(e)
    return str(got) if fn == "parse_spec" else got


SPEC_CASES = [("node",), ("slow:3",), ("crash:0",), ("flaky-admit:2",),
              ("", None), (":3",), ("slow:3:4",), ("slow:x",), ("slow:-1",),
              (None,), (7,), ("slow:1", "TRAIN_KINDS"),
              ("hang:1", "SERVE_KINDS"), ("hang:1", "TRAIN_KINDS"),
              ("sdc", "SERVE_KINDS"), ("pcie_slow", "SERVE_KINDS"),
              ("pcie_drop:1", "SERVE_KINDS"), ("tier_full", "SERVE_KINDS"),
              ("pcie_teleport", "SERVE_KINDS")]
SCHEDULE_CASES = [("3=crash:1, 7=slow:0", "SERVE_KINDS"),
                  ("3=sdc", "SERVE_KINDS"), ("x=crash:1", None),
                  ("crash:1", None), ("1=pcie_drop:0,,2=tier_full", None)]


@pytest.mark.parametrize("case", SPEC_CASES + [("schedule",) + c
                                               for c in SCHEDULE_CASES],
                         ids=repr)
def test_faultspec_parses_as_the_reference(case):
    fn = "parse_schedule" if case[0] == "schedule" else "parse_spec"
    args = case[1:] if case[0] == "schedule" else case
    text, kinds = args[0], (args[1] if len(args) > 1 else None)
    ours = _parse(faultspec, fn, text,
                  None if kinds is None else getattr(faultspec, kinds))
    ref = _parse(jfaultspec, fn, text,
                 None if kinds is None else getattr(jfaultspec, kinds))
    assert ours == ref


def _injector_answers(mod):
    """test_serve_gateway's injector predicates and test_kv_tier's
    self-clocking tier adapter, every answer recorded."""
    out = []
    for bad in ({1: "sdc"}, {-1: "crash:0"}):
        with pytest.raises(ValueError) as info:
            mod.ServeFaultInjector(bad)
        out.append(str(info.value))
    inj = mod.ServeFaultInjector({1: "crash:0", 2: "slow:1", 3: "hang:2",
                                  4: "flaky-admit:1", 5: "pcie_slow:0",
                                  6: "pcie_drop:1", 7: "tier_full"},
                                 slow_factor=3.0, slow_ticks=2,
                                 flaky_ticks=2, pcie_ticks=3)
    for t in range(1, 9):
        out.append(str(inj.advance(t)))
    out.append(inj.advance(3))                 # fires once
    with pytest.raises(mod.ReplicaCrash):
        inj.check_alive(0)
    for r in range(3):
        for t in range(1, 11):
            out.append((inj.crashed(r), inj.hung(r), inj.heartbeats(r),
                        inj.slow_multiplier(r, t), inj.admit_fails(r, t),
                        inj.pcie_slow_multiplier(r, t), inj.pcie_drops(r, t),
                        inj.tier_full(r, t)))
    inj.revive(2)
    out += [inj.heartbeats(2), inj.events]
    ad = mod.TierFaultAdapter(mod.ServeFaultInjector({0: "pcie_drop"}), 0)
    out.append(ad.drop())
    for _ in range(8):
        ad.on_tick()
        out.append((ad.drop(), ad.slow(), ad.full()))
    return out


def test_injector_answers_as_the_reference():
    assert _injector_answers(fault) == _injector_answers(jfault)


def _router_answers(mod):
    """test_serve_gateway's circuit-breaker unit check."""
    router = mod.Router(threshold=1, cooldown=5)
    rep = mod.Replica(0, engine=None)
    router.on_failure(rep, tick=10)
    out = [rep.circuit]
    gr = mod.GatewayRequest(gid=0, prompt=np.arange(4))
    out.append(len(router.routable([rep], tick=12)))
    out.append(len(router.routable([rep], tick=15)))
    out.append(rep.circuit)
    out.append(router.route(gr, [rep], tick=15) is rep)
    out.append(rep.probe_gid)
    out.append(router.route(dataclasses.replace(gr, gid=1), [rep],
                            tick=15))
    router.on_success(rep)
    out.append(rep.circuit)
    with pytest.raises(ValueError) as info:
        mod.ReplicaRegistry(3, 3)
    out.append(str(info.value))
    return out


def test_router_answers_as_the_reference():
    ours = _router_answers(gateway)
    assert ours == _router_answers(jgateway)
    assert ours[:4] == [gateway.OPEN, 0, 1, gateway.HALF_OPEN]


# ---------------------------------------------------------------------------
# Gateways against the JAX gateway
# ---------------------------------------------------------------------------


class Side:
    """The JAX gateway or the port's, on the weights both share."""

    def __init__(self, port, weights):
        cfg, jp, tcfg, tp = weights
        self.port = port
        self.cfg, self.params = (tcfg, tp) if port else (cfg, jp)
        self.mod = gateway if port else jgateway
        self.fault = fault if port else jfault
        self.tier = tier if port else jtier

    def injector(self, schedule, **kw):
        return self.fault.ServeFaultInjector(schedule, **kw)

    def gateway(self, tiered=False, **kw):
        """test_serve_gateway's dense pool, or test_kv_tier's tiered one:
        three 4-page requests per 3-slot replica against a 10-page pool,
        so the rotation quantum forces spills and fetches."""
        if self.port:
            kw["device"] = "cpu"
        kw.setdefault("replicas", 2)
        kw.setdefault("max_len", 64)
        kw.setdefault("chunk", 4)
        if tiered:
            kw.setdefault("slots", 3)
            kw.update(paged=True, page_size=8, pool_pages=10,
                      page_storage="bf16", prefill_chunk=8,
                      host_tier_pages=32,
                      tier_config=self.tier.TierConfig(quantum=4))
        else:
            kw.setdefault("slots", 2)
        kw.setdefault("params", self.params)
        return self.mod.Gateway(self.cfg, **kw)


def _summary(gw, reqs, **extra):
    reps = list(gw.registry.replicas.values())
    return dict(
        delivered=[list(r.delivered) for r in reqs],
        states=[r.state for r in reqs], retries=[r.retries for r in reqs],
        replicas=[r.replica for r in reqs],
        errors=[r.error for r in reqs], stats=dict(gw.stats),
        health=gw.registry.states(), circuits=[r.circuit for r in reps],
        reports=[(r.load, r.occupancy, r.free_pages, r.host_occupancy,
                  r.host_free_pages, r.tier_suspended) for r in reps],
        engines=[({k: v for k, v in r.engine.stats.items()
                   if k != "dispatches"}, r.engine.tier_stats(),
                  r.engine.pool_stats(), r.engine.prefix_stats())
                 for r in reps],
        events=None if gw.injector is None else gw.injector.events,
        **extra)


def _base(side, **kw):
    gw = side.gateway(**kw)
    reqs = [gw.submit(np.arange(4 + i), max_new=6) for i in range(3)]
    gw.run_until_done()
    return _summary(gw, reqs)


def _crash(side, **kw):
    """A replica crashes mid-decode: its residents finish on the survivor
    as continuations; what was delivered before the crash stays."""
    gw = side.gateway(injector=side.injector({2: "crash:0"}), **kw)
    reqs = [gw.submit(np.arange(4 + i), max_new=6) for i in range(3)]
    pre = None
    for _ in range(100):
        gw.tick()
        if gw.clock == 1:
            pre = [list(r.delivered) for r in reqs]
        if not gw.outstanding():
            break
    return _summary(gw, reqs, pre=pre)


def _crash_sampled(side):
    return _crash(side, temperature=0.8, top_k=8)


def _hang(side):
    """Missed heartbeats walk HEALTHY -> SUSPECT -> DEAD."""
    gw = side.gateway(injector=side.injector({2: "hang:0"}),
                      suspect_after=2, dead_after=4)
    reqs = [gw.submit(np.arange(4 + i), max_new=8) for i in range(4)]
    seen = []
    for _ in range(100):
        gw.tick()
        seen.append(gw.registry.replicas[0].state)
        if not gw.outstanding():
            break
    return _summary(gw, reqs, seen=seen)


def _flaky_admit(side):
    """Failed admissions trip the breaker; a half-open probe closes it."""
    gw = side.gateway(injector=side.injector({1: "flaky-admit:0"},
                                             flaky_ticks=4),
                      slots=1, circuit_threshold=2, circuit_cooldown=3)
    reqs = [gw.submit(np.arange(4 + i % 3), max_new=6) for i in range(6)]
    seen = []
    for _ in range(200):
        gw.tick()
        seen.append(gw.registry.replicas[0].circuit)
        if not gw.outstanding():
            break
    return _summary(gw, reqs, seen=seen)


def _slow(side):
    """A straggler keeps heartbeating and finishes its residents late."""
    gw = side.gateway(injector=side.injector({1: "slow:0"}, slow_factor=4.0,
                                             slow_ticks=8))
    reqs = [gw.submit(np.arange(4 + i), max_new=6) for i in range(3)]
    gw.run_until_done()
    return _summary(gw, reqs)


def _all_dead(side):
    gw = side.gateway(injector=side.injector({1: "crash:0", 2: "crash:1"}))
    reqs = [gw.submit(np.arange(4), max_new=8)]
    gw.run_until_done()
    return _summary(gw, reqs)


def _retry_budget(side):
    gw = side.gateway(replicas=1, slots=4, max_retries=0,
                      injector=side.injector({2: "crash:0"}))
    reqs = [gw.submit(np.arange(4), max_new=12)]
    gw.run_until_done()
    return _summary(gw, reqs)


def _shed(side):
    """Over the occupancy watermark, low priorities are shed."""
    gw = side.gateway(replicas=1, shed_watermark=0.5, shed_min_priority=1)
    reqs = [gw.submit(np.arange(4 + i), max_new=12) for i in range(2)]
    gw.tick()
    reqs.append(gw.submit(np.arange(6), max_new=4, priority=0))
    reqs.append(gw.submit(np.arange(7), max_new=4, priority=2))
    gw.run_until_done()
    return _summary(gw, reqs)


def _deadline(side):
    """A tick deadline cancels a running request and frees its slot."""
    gw = side.gateway(replicas=1, chunk=2)
    reqs = [gw.submit(np.arange(4), max_new=32, timeout_ticks=2),
            gw.submit(np.arange(5), max_new=4)]
    gw.run_until_done()
    eng = gw.registry.replicas[0].engine
    return _summary(gw, reqs, idle=all(r is None for r in eng.active))


def _tiered(side, schedule=None, **kw):
    """test_kv_tier's page-oversubscribed batch on tiered replicas, with
    a link fault on replica 0 for 12 ticks."""
    inj = None if schedule is None else side.injector(schedule,
                                                      pcie_ticks=12)
    gw = side.gateway(tiered=True, injector=inj, **kw)
    reqs = [gw.submit(np.arange(4 + i), max_new=24, seed=i)
            for i in range(6)]
    gw.run_until_done()
    return _summary(gw, reqs)


SCENARIOS = {
    "base": _base, "crash": _crash, "crash_sampled": _crash_sampled,
    "hang": _hang, "flaky_admit": _flaky_admit, "slow": _slow,
    "all_dead": _all_dead, "retry_budget": _retry_budget, "shed": _shed,
    "deadline": _deadline, "tier_base": _tiered,
    "pcie_slow": lambda s: _tiered(s, {4: "pcie_slow:0"}),
    "pcie_drop": lambda s: _tiered(s, {4: "pcie_drop:0"}),
    "tier_full": lambda s: _tiered(s, {3: "tier_full"}),
    "pcie_drop_sampled": lambda s: _tiered(s, {4: "pcie_drop:0"},
                                           temperature=0.8, top_k=8),
}
SAMPLED = {"crash_sampled": lambda s: _base(s, temperature=0.8, top_k=8),
           "pcie_drop_sampled": lambda s: _tiered(s, temperature=0.8,
                                                  top_k=8)}


@pytest.fixture(scope="module")
def jax_runs(qwen):
    """Every scenario on the JAX gateway, once for the module."""
    with kernels.use_backend("ref"):
        return {name: fn(Side(False, qwen))
                for name, fn in SCENARIOS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gateway_equals_jax(qwen, jax_runs, name):
    side = Side(True, qwen)
    ours = SCENARIOS[name](side)
    ref = dict(jax_runs[name])
    if name in SAMPLED:
        # the port samples from its own generator: its streams must equal
        # its own fault-free run's, everything else the JAX gateway's
        streams = ours.pop("delivered")
        ref.pop("delivered")
        assert streams == SAMPLED[name](side)["delivered"]
        pre = ours.pop("pre", None)
        ref.pop("pre", None)
        for before, got in zip(pre or [], streams):
            assert got[:len(before)] == before  # delivered is never redone
    assert ours == ref
    ours.setdefault("delivered", streams if name in SAMPLED else None)
    if name == "crash":
        assert ours["stats"]["retries"] > 0
        assert ours["health"][0] == gateway.DEAD
        assert ours["delivered"] == jax_runs["base"]["delivered"]
        for pre, got in zip(ours["pre"], ours["delivered"]):
            assert got[:len(pre)] == pre        # delivered is never redone
    elif name == "hang":
        assert {gateway.SUSPECT, gateway.DEAD} <= set(ours["seen"])
        assert ours["circuits"][0] == gateway.OPEN
        assert ours["stats"]["replica_deaths"] == 1
    elif name == "flaky_admit":
        assert gateway.OPEN in ours["seen"]
        assert ours["circuits"][0] == gateway.CLOSED
        assert ours["health"][0] == gateway.HEALTHY
    elif name == "slow":
        assert ours["health"][0] == gateway.HEALTHY
        assert ours["stats"]["retries"] == 0
    elif name == "all_dead":
        assert ours["states"] == ["failed"]
        assert "no live replicas" in ours["errors"][0]
    elif name == "retry_budget":
        assert ours["states"] == ["failed"]
    elif name == "shed":
        assert ours["states"] == ["done", "done", "shed", "done"]
        assert ours["stats"]["shed"] == 1
    elif name == "deadline":
        assert ours["states"] == ["timed_out", "done"]
        assert 0 < len(ours["delivered"][0]) < 32 and ours["idle"]
    elif name.startswith(("pcie", "tier_full")):
        if name not in SAMPLED:
            assert ours["delivered"] == jax_runs["tier_base"]["delivered"]
    if name.startswith(("tier", "pcie")):
        assert any(e[1]["suspensions"] > 0 for e in ours["engines"])
        for rep, (_, ts, _, _) in zip(ours["reports"], ours["engines"]):
            assert rep[4] == ts["host_pages_free"] <= 32
            assert rep[5] == ts["suspended"] == 0
            assert ts["transfers_inflight"] == 0
    if name not in ("all_dead", "retry_budget", "shed", "deadline"):
        assert set(ours["states"]) == {"done"}


def test_replicas_share_one_parameter_set(qwen):
    """The second replica gets the first's prepared weights: the same
    tensors, no copy."""
    gw = Side(True, qwen).gateway(params=None)
    a, b = (r.engine.params for r in gw.registry.replicas.values())

    def ptrs(tree):
        if isinstance(tree, dict):
            return {k: ptrs(v) for k, v in tree.items()}
        return tree.data_ptr() if isinstance(tree, torch.Tensor) else tree

    assert ptrs(a) == ptrs(b)
    assert gw.params is a


def test_drain_and_backpressure(qwen):
    """Drain finishes residents and refuses admits; a full gateway queue
    raises; both with typed backpressure."""
    side = Side(True, qwen)
    gw = side.gateway()
    reqs = [gw.submit(np.arange(4 + i), max_new=8) for i in range(3)]
    gw.tick()
    gw.drain()
    with pytest.raises(AdmissionError, match="draining"):
        gw.submit(np.arange(4), max_new=4)
    gw.run_until_done()
    assert all(r.state == "done" for r in reqs)
    gw = side.gateway(max_pending=2)
    ok = [gw.submit(np.arange(4), max_new=4) for _ in range(2)]
    with pytest.raises(AdmissionError, match="queue full"):
        gw.submit(np.arange(4), max_new=4)
    assert gw.stats["rejected"] == 1
    gw.run_until_done()
    assert all(r.state == "done" for r in ok)


def test_routing_spreads_and_keeps_affinity(qwen):
    side = Side(True, qwen)
    gw = side.gateway()
    reqs = [gw.submit(np.arange(4) + 10 * i, max_new=8) for i in range(4)]
    gw.tick()
    assert {gr.replica for gr in reqs} == {0, 1}
    gw.run_until_done()
    assert all(r.state == "done" for r in reqs)
    gw = side.gateway()
    a = gw.submit(np.arange(8), max_new=4)
    gw.run_until_done()
    b = gw.submit(np.arange(8), max_new=4)
    gw.run_until_done()
    assert b.replica == a.replica and gw.router.affinity_hits >= 1


class _Boom(RuntimeError):
    """Stands for an engine error that is not a replica fault (a CUDA
    error, a failed build or capture)."""


def test_an_engine_error_is_not_a_dead_replica(qwen):
    """Only ReplicaCrash and AdmissionError are replica faults: any other
    error of an engine propagates out of ``tick()``, and the replica is
    neither marked dead nor its requests retried."""
    gw = Side(True, qwen).gateway()
    gw.submit(np.arange(4), max_new=8)
    gw.tick()
    eng = gw.registry.replicas[0].engine

    def boom():
        raise _Boom("device error")
    eng.step = boom
    with pytest.raises(_Boom):
        gw.tick()
    assert gw.registry.states() == {0: gateway.HEALTHY, 1: gateway.HEALTHY}
    assert gw.stats["retries"] == 0 and gw.stats["replica_deaths"] == 0
