"""PyTorch port: the launchers against the reference's CLIs on smoke
qwen3-14b, on the CPU (helpers: ``tests/test_torch_launch.py``).

* ``serve --gateway 2 --chaos "6=crash:0,9=slow:1"``: the gateway's
  counters, each replica's health, the faults fired and the delivered
  streams, printed as the reference prints them (one token a tick and two
  slots a replica, so that the faults land mid-run);
* ``serve --paged --host-tier-pages 16`` with two slots for four
  requests, one token a tick: residents rotate out through the host tier
  (the tier line equal to the reference's);
* ``train --smoke --steps 3 --batch 2 --seq 32``: the history within 1e-5
  (relative) of the reference CLI's ``Trainer``, started from its state,
  and the printed line equal.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_launch import BASE, check_serve, reference
from repro.launch import train as jtrain
from repro.train.trainer import Trainer as JTrainer
from repro_torch import bridge
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.launch import train

QWEN = BASE + ["--arch", "qwen3-14b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gateway_prints_the_reference_lines(monkeypatch, capsys):
    res, lines = check_serve(
        QWEN + ["--gateway", "2", "--chaos", "6=crash:0,9=slow:1",
                "--requests", "6", "--max-new", "12", "--chunk", "1",
                "--slots", "2"], monkeypatch, capsys)
    s = res["stats"]
    assert s["completed"] == s["submitted"] == 6
    assert s["replica_deaths"] == 1 and s["retries"] > 0
    assert all(g.done for g in res["requests"])
    assert res["engine"].registry.states() == {0: "dead", 1: "healthy"}
    assert any(x.startswith("[serve] chaos fired") for x in lines)


def test_host_tier_prints_the_reference_lines(monkeypatch, capsys):
    res, lines = check_serve(
        QWEN + ["--paged", "--slots", "2", "--host-tier-pages", "16",
                "--max-new", "12", "--chunk", "1"], monkeypatch, capsys)
    ts = res["engine"].tier_stats()
    assert ts["suspensions"] == ts["resumes"] > 0
    assert any(x.startswith("[serve] host tier (16 pages)") for x in lines)


def test_train_follows_the_reference_cli(monkeypatch, capsys):
    argv = ["--arch", "qwen3-14b", "--smoke", "--steps", "3", "--batch",
            "2", "--seq", "32"]
    seen = {}
    run = JTrainer.run

    def spy(self, steps):
        seen["params"] = jax.tree.map(np.asarray, self.params)
        seen["out"] = run(self, steps)
        return seen["out"]

    monkeypatch.setattr(JTrainer, "run", spy)
    ref = reference(jtrain.main, argv, monkeypatch, capsys)
    args = train.parser().parse_args(argv + ["--device", "cpu"])
    out = train.run(smoke_config(get_config(args.arch)), args,
                    params=bridge.params_from_jax(seen["params"]))
    assert capsys.readouterr().out.splitlines() == ref
    want = seen["out"]["history"]
    assert out["final_step"] == 3 and len(out["history"]) == len(want) == 3
    for a, b in zip(want, out["history"]):
        assert a["step"] == b["step"]
        assert abs(b["loss"] - a["loss"]) <= 1e-5 * abs(a["loss"]), (a, b)
