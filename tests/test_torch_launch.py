"""PyTorch port: ``repro_torch.launch.serve`` against the reference's CLI
on smoke DeepSeek-V3, on the CPU; the helpers here serve
``tests/test_torch_launch_qwen.py`` too.

The reference's ``main`` runs with ``sys.argv`` monkeypatched (its
registry's ``ref`` backend) and its lines are read with ``capsys``; the
port's ``run`` takes the same arguments plus ``--device cpu`` and the
reference engine's seeded init, bridged. Every printed line must equal
the reference's (the ``req i: ... -> [...]`` streams, the stats dict, the
acceptance, the bucket list, the paged and disaggregation lines), but for
the value of ``dispatches`` in a printed stats dict (the port counts its
own, ``serve/engine.py``) and, with a host tier, the ``decode
dispatches/token`` figure, which subtracts the reference's count of
admissions from the total: the port counts the tier's transfers its own
way as well. The returned stats must equal the reference's on every other
key and ``compiled_prefill_buckets`` its bucket list, with MTP drafting,
with paged fp8 pages and disaggregated. Each invalid flag combination
must raise the reference's ``SystemExit`` with its text, and ``--device
cuda`` without a card must raise.
"""
import ast
import functools
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro import kernels
from repro.configs.base import get_config, smoke_config
from repro.launch import serve as jserve
from repro.models.api import Model as JModel
from repro_torch import bridge
from repro_torch.launch import serve, train
from _torch_threads import one_thread  # noqa: F401

BASE = ["--smoke", "--requests", "4", "--max-new", "6"]


@functools.lru_cache(maxsize=None)
def weights(arch):
    """The port's copy of the reference engine's seeded init of smoke
    ``arch``."""
    jp = jax.jit(JModel(smoke_config(get_config(arch))).init)(
        jax.random.PRNGKey(0))
    return bridge.params_from_jax(jax.tree.map(np.asarray, jp))


def reference(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["launch"] + argv)
    capsys.readouterr()
    with kernels.use_backend("ref"):
        main()
    return capsys.readouterr().out.splitlines()


def port_serve(argv, capsys):
    args = serve.parser().parse_args(argv + ["--device", "cpu"])
    capsys.readouterr()
    res = serve.run(serve.config(args), args, params=weights(args.arch))
    return res, capsys.readouterr().out.splitlines()


def masked(lines, tiered):
    out = [re.sub(r"'dispatches': \d+", "'dispatches': _", x)
           for x in lines]
    if tiered:
        out = [re.sub(r"dispatches/token = [\d.]+", "dispatches/token = _",
                      x) for x in out]
    return out


def check_serve(argv, monkeypatch, capsys):
    """Run both; every printed line equal (masked), the returned stats
    equal to the reference's printed dict but ``dispatches``, and the
    engine's ``compiled_prefill_buckets`` the printed bucket list.
    Returns the port's result and lines."""
    ref = reference(jserve.main, argv, monkeypatch, capsys)
    res, ours = port_serve(argv, capsys)
    tiered = "--host-tier-pages" in argv
    assert masked(ours, tiered) == masked(ref, tiered)
    assert sum(x.startswith("  req ") for x in ours) == 3
    if "--gateway" in argv:
        return res, ours
    assert all(r.done for r in res["requests"])
    want = ast.literal_eval(re.search(r"\{'steps'[^}]*\}",
                                      "\n".join(ref)).group(0))
    assert {k: v for k, v in res["stats"].items() if k != "dispatches"} == \
        {k: v for k, v in want.items() if k != "dispatches"}
    buckets = re.search(r"prefill buckets compiled: (\[[^\]]*\])",
                        "\n".join(ref)).group(1)
    assert res["engine"].compiled_prefill_buckets == \
        ast.literal_eval(buckets)
    return res, ours


SCENARIOS = {
    "mtp": ["--mtp"],
    "paged_fp8": ["--paged", "--page-storage", "fp8"],
    "disagg": ["--disagg"],
}
INVALID = [
    ["--host-tier-pages", "8"],
    ["--paged", "--host-tier-pages", "8", "--disagg"],
    ["--mesh", "2"],
    ["--mesh", "a,b"],
    ["--mesh", "1x2x2"],
    ["--prefill-mesh", "1,2"],
    ["--chaos", "6=crash:0"],
    ["--gateway", "2", "--disagg"],
    ["--page-storage", "fp16"],
    ["--moe-impl", "ep"],
]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_serve_prints_the_reference_lines(name, monkeypatch, capsys):
    res, lines = check_serve(
        BASE + ["--arch", "deepseek-v3-671b"] + SCENARIOS[name],
        monkeypatch, capsys)
    if name == "mtp":
        assert res["stats"]["drafts"] > 0
        assert any("MTP speedup model" in x for x in lines)
    if name == "paged_fp8":
        assert res["engine"].free_pages() == res["engine"].pool_pages
    if name == "disagg":
        assert lines[0].startswith("[serve] disaggregated: handoff")


@pytest.mark.parametrize("argv", INVALID, ids=" ".join)
def test_invalid_flags_exit_with_the_reference_text(argv, monkeypatch,
                                                    capsys):
    argv = ["--arch", "qwen3-14b", "--smoke"] + argv
    with pytest.raises(SystemExit) as want:
        reference(jserve.main, argv, monkeypatch, capsys)
    want_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as got:
        serve.main(argv + ["--device", "cpu"])
    assert got.value.code == want.value.code
    # argparse's own refusals (code 2) print their message after the usage
    assert capsys.readouterr().err.split("error:")[-1] == \
        want_err.split("error:")[-1]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="GPU"):
        serve.main(["--arch", "qwen3-14b", "--smoke"])
    with pytest.raises(RuntimeError, match="GPU"):
        train.main(["--arch", "qwen3-14b", "--smoke", "--steps", "1"])
