"""PyTorch port: ``repro_torch.parallel.collectives`` against the JAX
reference ``repro.parallel.collectives``.

``compressed_psum`` runs on 4 gloo ranks on the CPU, spawned and joined
through a ``FileStore`` in ``tmp_path`` (the rank body is
``tests/_torch_ring.py``, which imports no JAX); the reference runs under
a jitted ``shard_map`` on 4 forced host devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` does). One start of each side runs every
case: the 4-rank ring, two 2-rank rings (subgroups [0, 1] and [2, 3]) and
rings of one. Inputs come from numpy seeds.

Member by member, elements further apart than 1e-5 of max|exact| (exact
= the fp64 sum of the members' inputs) must number under 0.1%: the
codec's own allowance for one-level tie flips between two libms'
log/exp. That holds where no sum cancels towards zero, so these cases
draw each element's sign once for all members (|x| in [1, 2)). Where
sums do cancel (zero-mean normal inputs, the reference's own test), a
last-ulp difference in a near-zero sum moves its tile's log-domain
minimum, hence the tile's whole grid, at the next hop: the two rings then
differ in many elements by up to a grid step, on either side of the exact
sum. There both must stay within 0.05 of max|exact| at 10 bits,
the reference's bound (``tests/test_distributed.py``), with RMS errors
within 10% of each other. The checksums must be equal bit for bit.
"""
import multiprocessing
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ring
from repro.parallel import collectives as jcol
from repro_torch.parallel import collectives

WORLD = 4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# per-member input shape of each case (bf16: a (..., d) input whose 10
# rows pad to 12; ragged: d 200 pads to 256 and 13 rows to 16)
SHAPES = {"gauss_10bit": (8, 256), "f32_10bit": (8, 256),
          "ragged_8bit": (13, 200),
          "bf16_8bit": (2, 5, 384), "pairs_8bit": (8, 256),
          "single_8bit": (3, 128)}
MEMBERS = {"world": [range(4)] * 4, "pairs": [range(0, 2)] * 2
           + [range(2, 4)] * 2, "single": [[r] for r in range(4)]}

JAX_RING = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.parallel import collectives

CASES = {cases!r}
inputs = np.load({inputs!r})
devs = jax.devices()
assert len(devs) == 4, devs


def ring(xs, n_bits, dtype):
    mesh = Mesh(np.array(devs[:len(xs)]), ("pod",))
    f = lambda xl: collectives.compressed_psum(xl[0], "pod",
                                               n_bits=n_bits)[None]
    y = jax.jit(shard_map(f, mesh=mesh, in_specs=P("pod"),
                          out_specs=P("pod"), check_vma=False))(
        jnp.asarray(xs).astype(dtype))
    return np.asarray(y.astype(jnp.float32))


out = {{}}
for name, (layout, n_bits, dtype) in CASES.items():
    xs = inputs[name]
    groups = {{"world": [xs], "pairs": [xs[:2], xs[2:]],
              "single": [xs[i:i + 1] for i in range(4)]}}[layout]
    out[name] = np.concatenate([ring(g, n_bits, dtype) for g in groups])
np.savez({out!r}, **out)
"""


def _inputs():
    """Zero-mean normal inputs for ``gauss_10bit``; for the other cases
    each element's sign is drawn once for all members, |x| in [1, 2)."""
    out = {}
    for i, (name, shape) in enumerate(SHAPES.items()):
        g = np.random.default_rng([14, i])
        if name == "gauss_10bit":
            x = g.standard_normal((WORLD,) + shape)
        else:
            sign = np.where(g.random(shape) < 0.5, -1.0, 1.0)
            x = sign * (1.0 + g.random((WORLD,) + shape))
        x = x.astype(np.float32)
        if _torch_ring.CASES[name][2] == "bfloat16":     # bf16 values
            x = torch.from_numpy(x).bfloat16().float().numpy()
        out[name] = x
    return out


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    d = tmp_path_factory.mktemp("rings")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = JAX_RING.format(cases=_torch_ring.CASES,
                           inputs=str(d / "inputs.npz"),
                           out=str(d / "jax.npz"))
    jax_side = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=_torch_ring.run_rank,
                         args=(r, WORLD, str(d / "store"), str(d)))
             for r in range(WORLD)]
    for p in ranks:
        p.start()
    for p in ranks:
        p.join(timeout=240)
    codes = [p.exitcode for p in ranks]
    for p in ranks:
        if p.is_alive():
            p.kill()
    _, err = jax_side.communicate(timeout=240)
    assert codes == [0] * WORLD, codes
    assert jax_side.returncode == 0, err[-3000:]
    ours = [np.load(d / f"rank{r}.npz") for r in range(WORLD)]
    return inputs, ours, np.load(d / "jax.npz")


def _members(name):
    return MEMBERS[_torch_ring.CASES[name][0]]


@pytest.mark.parametrize("name", ["f32_10bit", "ragged_8bit", "bf16_8bit",
                                  "pairs_8bit"])
def test_compressed_psum_matches_jax_member_by_member(rings, name):
    inputs, ours, ref = rings
    for r, group in enumerate(_members(name)):
        exact = inputs[name][list(group)].astype(np.float64).sum(0)
        got, want = ours[r][name], ref[name][r]
        assert got.shape == want.shape == SHAPES[name]
        far = np.abs(got - want) > 1e-5 * np.abs(exact).max()
        assert far.mean() < 1e-3, (r, int(far.sum()), far.size)


@pytest.mark.parametrize("name", ["gauss_10bit", "f32_10bit"])
def test_compressed_psum_10bit_within_the_reference_bound(rings, name):
    inputs, ours, ref = rings
    exact = inputs[name].astype(np.float64).sum(0)
    scale = np.abs(exact).max()
    for r in range(WORLD):
        for y in (ours[r][name], ref[name][r]):
            assert np.abs(y - exact).max() < 0.05 * scale


def test_cancelling_sums_err_like_the_reference(rings):
    """Zero-mean inputs: member by member, the port's RMS error against
    the exact sum is within 10% of the reference's."""
    inputs, ours, ref = rings
    exact = inputs["gauss_10bit"].astype(np.float64).sum(0)
    for r in range(WORLD):
        e_ours = np.sqrt(((ours[r]["gauss_10bit"] - exact) ** 2).mean())
        e_ref = np.sqrt(((ref["gauss_10bit"][r] - exact) ** 2).mean())
        assert abs(e_ours - e_ref) <= 0.1 * e_ref, (r, e_ours, e_ref)


def test_bf16_input_gives_bf16_sum_of_bf16_values(rings):
    """The rank asserts the bf16 dtype; every value it returned is a bf16
    value, as JAX's is."""
    _, ours, ref = rings
    for r in range(WORLD):
        y = ours[r]["bf16_8bit"]
        assert (torch.from_numpy(y).bfloat16().float().numpy() == y).all()
        assert (ref["bf16_8bit"][r] == torch.from_numpy(
            ref["bf16_8bit"][r]).bfloat16().float().numpy()).all()


def test_ring_of_one_returns_x_untouched(rings):
    inputs, ours, ref = rings
    for r in range(WORLD):
        assert bool(ours[r]["single_8bit:same_object"])
        np.testing.assert_array_equal(ours[r]["single_8bit"],
                                      inputs["single_8bit"][r])
        np.testing.assert_array_equal(ref["single_8bit"][r],
                                      inputs["single_8bit"][r])


def test_world_ring_ran_each_case_in_the_world_group(rings):
    """Every rank of the 4-rank ring sums all four members (not a pair):
    its error against the 4-member sum is far below one member's size."""
    inputs, ours, _ = rings
    exact = inputs["ragged_8bit"].astype(np.float64).sum(0)
    for r in range(WORLD):
        err = np.abs(ours[r]["ragged_8bit"] - exact).max()
        assert err < 0.2 * np.abs(inputs["ragged_8bit"][0]).max()


# --- checksums (SDC guard): bit for bit ----------------------------------


def _checksum_input(shape, dtype):
    x = np.random.default_rng([14, 99, len(shape)]).standard_normal(shape)
    x = (x * 1e3).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("shape,dtype", [((37, 129), "float32"),
                                         ((64, 128), "bfloat16"),
                                         ((300_000,), "float32"),
                                         ((2, 3, 5), "float32")])
def test_fletcher64_equals_jax_bit_for_bit(shape, dtype):
    t, j = _checksum_input(shape, dtype)
    c = collectives.fletcher64(t)
    assert c.dtype == torch.int64 and c.shape == ()
    assert int(c) == int(jcol.fletcher64(j))
    assert collectives._np_fletcher64(t.float().numpy()) == \
        jcol._np_fletcher64(np.asarray(j.astype(jnp.float32))) == int(c)


def test_tree_checksum_and_device_checksums_equal_jax():
    t1, j1 = _checksum_input((37, 129), "float32")
    t2, j2 = _checksum_input((64, 128), "bfloat16")
    ours = {"w": t1, "blocks": [t2, torch.arange(5)]}
    ref = {"w": j1, "blocks": [j2, jnp.arange(5)]}
    assert int(collectives.tree_checksum(ours)) == \
        int(jcol.tree_checksum(ref))
    assert collectives.device_checksums(ours) == jcol.device_checksums(ref)
    # a single flipped bit shows
    bad = {"w": t1.clone(), "blocks": [t2, torch.arange(5)]}
    bad["w"].view(torch.int32)[3, 7] ^= 1
    assert collectives.device_checksums(bad) != \
        collectives.device_checksums(ours)
    assert jax.tree.leaves(ref)         # the reference tree is non-empty
