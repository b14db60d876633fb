"""Edge tiles of the LogFMT codec: one 1x128 tile per row, each built to
stress a corner of the per-tile statistics (the min and max of the logs,
the 2^32 range clamp, the step's 1e-12 floor, what counts as zero).

The reference's platforms treat fp32 subnormals as zero (denormals are
zero on XLA's CPU; the TPU flushes them), so a subnormal gets code 0 and
sign bit 0 and stays out of its tile's range; three rows hold that. Its
arithmetic has no subnormals either: a row of normals near 2^-126 holds
the encoder's grid points and differences to that.

``STRUCTURED`` rows have codes that follow from the grid alone: the
kernel must give exactly the plain version's codes on them. ``RANDOM``
rows hold drawn values (plus ±inf or NaN), where a last-ulp difference of
log/exp may flip a tie: they are held to the codec's standing tolerance.
Nothing here runs at import time.
"""
from __future__ import annotations

import numpy as np

TILE = 128
STRUCTURED = ("equal magnitudes", "single nonzero", "zeros",
              "past the clamp", "lone subnormal", "subnormals only",
              "normal among negative subnormals", "near the least normal",
              "range of 2^-23", "narrow")
RANDOM = ("inf", "nan")


def _signs(g, n=TILE):
    return np.where(g.random(n) < 0.5, -1.0, 1.0)


def edge_tiles(seed: int = 20) -> "tuple[np.ndarray, tuple[str, ...]]":
    """(len(STRUCTURED) + len(RANDOM), 128) float32 rows and their names,
    in the order ``STRUCTURED + RANDOM``."""
    g = np.random.default_rng(seed)
    rows = {}
    rows["equal magnitudes"] = 1.5 * _signs(g)
    one = np.zeros(TILE)
    one[37] = -3.25
    rows["single nonzero"] = one
    rows["zeros"] = np.where(g.random(TILE) < 0.5, -0.0, 0.0)
    # ln range 55, past the clamp's 22.18: the small values sit below mn
    rows["past the clamp"] = g.permutation(
        np.logspace(-12, 12, TILE) * _signs(g))
    # one subnormal in a tile spanning 7.9e27 .. 1e30
    rows["lone subnormal"] = np.concatenate(
        [[1e-38], np.linspace(7.9e27, 1e30, TILE - 1)])
    rows["subnormals only"] = np.geomspace(1e-42, 1.3e-40, TILE) * _signs(g)
    rows["normal among negative subnormals"] = np.concatenate(
        [[1.0], np.full(TILE - 1, -1e-42)])
    # normals from 1.2e-38: differences and grid points below 2^-126 are
    # zero on the reference's platforms
    rows["near the least normal"] = np.geomspace(1.2e-38, 1e-37, TILE)
    # 128 consecutive floats from 1.0: step 1.2e-7 at 8 bits, 4.6e-10 at
    # 16 (many grid points round to one float)
    ulps = 1.0 + np.arange(TILE) * 2.0 ** -23
    rows["range of 2^-23"] = g.permutation(ulps * _signs(g))
    # ln range 1/64: step 1.24e-4 at 8 bits, 3.1e-5 at 10
    rows["narrow"] = g.permutation(
        np.exp(np.linspace(0.0, 1.0 / 64, TILE)) * _signs(g))
    drawn = g.standard_normal((2, TILE)) * np.exp(g.standard_normal((2, TILE)))
    rows["inf"] = drawn[0]
    rows["inf"][[5, 77]] = [np.inf, -np.inf]
    rows["nan"] = drawn[1]
    rows["nan"][[3, 90]] = [np.nan, -np.nan]
    names = STRUCTURED + RANDOM
    return np.stack([rows[n] for n in names]).astype(np.float32), names
