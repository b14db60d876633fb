"""PyTorch port: the network models (``repro_torch.network.topology`` and
``.perfmodel``, standard library only) against the reference's, on every
case of ``tests/test_network_models.py``: Table 3's structures exactly and
its costs, the §2.3.2 speed limits and the all-to-all and MFU models at
float equality (the same arithmetic), and the paper's published numbers
(120.96 us, 14.76 ms, ~1200 tok/s). ``h800_ib_node_limited`` stands in
for the reference's accelerator mapping (``tpu_v5e_ici``): the same
fanouts on the paper's own fabric, where dedup must lift the limit above
1.9x the flat one.
"""
import dataclasses

import pytest

from repro.network import perfmodel as jperf
from repro.network import topology as jtopo
from repro_torch.network import perfmodel, topology


def test_table3_structures_and_costs_equal_the_reference():
    ours, ref = topology.table3(), jtopo.table3()
    assert ours.keys() == ref.keys() == topology.PAPER_TABLE3.keys()
    assert topology.PAPER_TABLE3 == jtopo.PAPER_TABLE3
    for name, t in ours.items():
        assert dataclasses.astuple(t) == dataclasses.astuple(ref[name])
        assert t.cost == ref[name].cost
        assert t.cost_per_endpoint == ref[name].cost_per_endpoint
        want = topology.PAPER_TABLE3[name]
        assert (t.endpoints, t.switches, t.links) == (
            want["endpoints"], want["switches"], want["links"]), name
        assert abs(t.cost / 1e6 - want["cost_m"]) / want["cost_m"] < 0.05
    assert ours["MPFT"].cost_per_endpoint < ours["FT3"].cost_per_endpoint
    assert abs(ours["MPFT"].cost_per_endpoint - 4390) < 50


@pytest.mark.parametrize("fn", ["paper_h800_ib", "paper_gb200"])
def test_speed_limits_equal_the_reference(fn):
    ours, ref = getattr(perfmodel, fn)(), getattr(jperf, fn)()
    assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    for key in ("comm_time_s", "layer_time_s", "tpot_s", "tokens_per_s"):
        assert getattr(ours, key) == getattr(ref, key), key


def test_paper_numbers():
    ib, gb = perfmodel.paper_h800_ib(), perfmodel.paper_gb200()
    assert abs(ib.comm_time_s * 1e6 - 120.96) < 0.01
    assert abs(ib.tpot_s * 1e3 - 14.76) < 0.01
    assert 66 <= ib.tokens_per_s <= 69
    assert abs(gb.comm_time_s * 1e6 - 6.72) < 0.01
    assert 1150 <= gb.tokens_per_s <= 1250


@pytest.mark.parametrize("dedup", [False, True])
def test_node_limited_fanouts_are_the_reference_mappings(dedup):
    ours, ref = (perfmodel.h800_ib_node_limited(dedup),
                 jperf.tpu_v5e_ici(dedup))
    assert (ours.bandwidth, ours.fanout, ours.hidden, ours.layers,
            ours.batch_per_device) == (ref.bandwidth, ref.fanout,
                                       ref.hidden, ref.layers,
                                       ref.batch_per_device)
    assert ours.tpot_s == ref.tpot_s


def test_node_limited_dedup_improves_limit():
    flat = perfmodel.h800_ib_node_limited(dedup=False)
    dedup = perfmodel.h800_ib_node_limited(dedup=True)
    assert dedup.tokens_per_s > 1.9 * flat.tokens_per_s


@pytest.mark.parametrize("msg", [256 * 1024, 2 ** 20, 256 * 2 ** 20])
@pytest.mark.parametrize("devices", [8, 128])
def test_busbw_equals_the_reference(msg, devices):
    assert perfmodel.alltoall_busbw(msg, devices) == \
        jperf.alltoall_busbw(msg, devices)


def test_busbw_saturates():
    small = perfmodel.alltoall_busbw(256 * 1024, 128)
    large = perfmodel.alltoall_busbw(256 * 2 ** 20, 128)
    assert small < large and large > 45e9


def test_mfu_equals_the_reference_and_the_paper_ratio():
    kw = dict(tokens_per_step=1.0, step_time_s=1.0, n_active=37e9,
              seq_len=4096, n_layers=61, n_heads=128, head_dim=128,
              peak_flops=1e12)
    m = perfmodel.mfu(**kw)
    assert m == jperf.mfu(**kw)
    assert abs(m["mfu_causal"] / m["mfu_noncausal"] - 385 / 432) < 0.05
