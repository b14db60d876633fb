"""PyTorch port: the launchers' ``--mesh`` runs on the CPU, smoke
qwen3-14b. The launcher spawns one gloo process per mesh position (one
torch thread each here: the module pins the parent's threads to one, and
a rank takes the parent's count over the world size).

* ``serve --mesh 1,2 --wire fp32`` gives the single-device streams
  exactly (the reference's sharded-serving contract for dense GQA), and
  its stats equal the single-device run's;
* ``train --mesh 1x2 --steps 2`` gives the single-device losses within
  1e-5 (relative);
* a rank that raises ends the command with a non-zero exit and that
  rank's traceback (the port's ``Disaggregator`` refusing a rank off the
  prefill mesh, while the other rank waits in a collective), and the
  port's refusals of a second data axis (A.8) and of ``--devices`` below
  the mesh size come before any spawn.
"""
import pytest
import torch

from repro_torch.launch import serve, train

SERVE = ["--arch", "qwen3-14b", "--smoke", "--requests", "4", "--max-new",
         "6", "--device", "cpu"]
TRAIN = ["--arch", "qwen3-14b", "--smoke", "--steps", "2", "--batch", "2",
         "--seq", "32", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_meshed_serve_gives_the_single_device_streams(capsys):
    one = serve.main(SERVE)
    capsys.readouterr()
    meshed = serve.main(SERVE + ["--mesh", "1,2", "--wire", "fp32"])
    lines = capsys.readouterr().out.splitlines()
    assert meshed["engine"] is None
    assert [list(r.out) for r in meshed["requests"]] == \
        [list(r.out) for r in one["requests"]]
    assert all(r.done for r in meshed["requests"])
    assert meshed["stats"] == one["stats"]
    assert any(x.startswith("[serve] sharded over mesh {'data': 1, "
                            "'model': 2} (EP degree 2)") for x in lines)
    assert sum(x.startswith("  req ") for x in lines) == 3


def test_meshed_train_gives_the_single_device_losses(capsys):
    one = train.main(TRAIN)
    meshed = train.main(TRAIN + ["--mesh", "1x2"])
    lines = capsys.readouterr().out.splitlines()
    assert meshed["mesh_shape"] == (1, 2) and meshed["final_step"] == 2
    for a, b in zip(one["history"], meshed["history"], strict=True):
        assert abs(b["loss"] - a["loss"]) <= 1e-5 * abs(a["loss"]), (a, b)
    assert lines[-1].startswith("[train] mesh (1, 2) moe_impl=ep_dedup "
                                "wire=fp8 microbatches=2")


def test_a_failed_rank_fails_the_command():
    with pytest.raises(SystemExit) as e:
        serve.main(SERVE + ["--mesh", "1,2", "--disagg", "--prefill-mesh",
                            "1,1"])
    msg = str(e.value.code)
    assert msg.startswith("rank 1 of 2 failed:")
    assert "Traceback" in msg and "a rank outside the prefill mesh" in msg


@pytest.mark.parametrize("argv,err,match", [
    (["--mesh", "1x1x2"], NotImplementedError, "A.8"),
    (["--mesh", "1x2", "--devices", "1"], ValueError, "fewer than"),
])
def test_train_mesh_refusals_come_before_any_spawn(argv, err, match):
    with pytest.raises(err, match=match):
        train.main(TRAIN + argv)
