"""PyTorch port: the trainer substrate — port-only mirrors of
``tests/test_train_infra.py`` (optimizer math, checkpoint atomicity and
newest-intact restore, fault injection and SDC recovery, data
determinism, convergence; the meshed ``test_elastic_restore_shardings``
waits for expert parallelism) and of ``tests/test_system.py::
test_train_checkpoint_serve_roundtrip``; the data pipeline bit for bit
against the reference's; and 5-step ``Trainer`` trajectories on smoke
DeepSeek-V3 against the reference's ``Trainer``, started from one state
(``bridge.train_state_from_jax``).

The failure-recovery test trains the reference's ``qwen1.5-4b`` and, as
before the port had that config, smoke qwen3-14b. Trajectory
tolerances: the loss per step within 1e-5 relative without FP8 and 2e-3
with it (an FP8 quantization is discontinuous: an ulp of difference in
its input now and then flips an E4M3 code, see ``test_torch_train.py``;
the flips compound over the steps); router biases equal.
"""
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, smoke_config
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainConfig as JTrainConfig
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.data.pipeline import Prefetcher, SyntheticCorpus
from repro_torch.models.api import Model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as optim
from repro_torch.train import schedule as sched
from repro_torch.train.fault import (FailureInjector, NodeFailure,
                                     StragglerMonitor)
from repro_torch.train.trainer import Trainer, TrainConfig, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this test process: the suite runs files in
    parallel workers on one CPU, and torch's default of a thread per core
    in each worker oversubscribes it (these smoke shapes then run up to a
    hundred times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


class TestOptimizer:
    def test_adamw_descends_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        st = optim.init(params)
        for _ in range(200):
            g = {"w": 2 * params["w"]}
            params, st, _ = optim.update(g, st, params, lr=0.05,
                                         weight_decay=0.0)
        assert float(params["w"].abs().max()) < 0.2

    def test_state_dtypes_paper_recipe(self):
        """fp32 master, bf16 m/v (10 bytes/param)."""
        params = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
        st = optim.init(params)
        assert st.master["w"].dtype == torch.float32
        assert st.m["w"].dtype == torch.bfloat16
        assert st.v["w"].dtype == torch.bfloat16
        assert st.step.dtype == torch.int32 and int(st.step) == 0

    def test_grad_clip(self):
        params = {"w": torch.zeros(8)}
        st = optim.init(params)
        g = {"w": torch.full((8,), 1e6)}
        _, _, stats = optim.update(g, st, params, lr=1.0, clip_norm=1.0)
        assert float(stats["grad_norm"]) > 1e5   # reported pre-clip

    def test_no_decay_on_1d(self):
        params = {"gamma": torch.ones(16), "w": torch.ones((4, 4))}
        st = optim.init(params)
        g = {k: torch.zeros_like(v) for k, v in params.items()}
        p2, _, _ = optim.update(g, st, params, lr=0.1, weight_decay=0.5)
        np.testing.assert_allclose(p2["gamma"].numpy(), 1.0)
        assert float(p2["w"].max()) < 1.0        # decayed

    def test_none_grad_is_a_zero_grad(self):
        """A leaf without a gradient (the router bias) follows the zero-
        gradient arithmetic, as jax.grad's zeros do."""
        def run(g):
            params = {"b": torch.ones((2, 4)), "w": _randn(3, 4)}
            st = optim.init(params)
            st.m["b"].fill_(0.5)
            st.v["b"].fill_(0.25)
            optim.update({"b": g, "w": torch.ones(3, 4)}, st, params,
                         lr=1e-2)
            return params, st

        a, sa = run(None)
        b, sb = run(torch.zeros(2, 4))
        for x, y in ((a["b"], b["b"]), (sa.m["b"], sb.m["b"]),
                     (sa.v["b"], sb.v["b"]),
                     (sa.master["b"], sb.master["b"])):
            assert torch.equal(x, y)
        assert not torch.equal(a["b"], torch.ones(2, 4))   # decayed, moved

    def test_update_in_place_in_chunks(self, monkeypatch):
        """Leaves larger than a chunk update chunk by chunk, bit for bit
        as whole (the chunks bound the fp32 temporaries)."""
        def run():
            params = {"w": _randn(37, 29, seed=1).bfloat16()}
            st = optim.init(params)
            ptr = params["w"].data_ptr()
            optim.update({"w": _randn(37, 29, seed=2).bfloat16()}, st,
                         params, lr=1e-3)
            assert params["w"].data_ptr() == ptr
            return params["w"], st.master["w"], st.m["w"], st.v["w"]

        whole = run()
        monkeypatch.setattr(optim, "CHUNK", 100)
        for a, b in zip(whole, run()):
            assert torch.equal(a, b)

    def test_schedule(self):
        lr0 = sched.warmup_cosine(0, peak_lr=1.0, warmup=10, total=100)
        lr10 = sched.warmup_cosine(10, peak_lr=1.0, warmup=10, total=100)
        lr100 = sched.warmup_cosine(100, peak_lr=1.0, warmup=10, total=100)
        assert float(lr0) == 0.0 and float(lr10) == 1.0
        assert 0.05 < float(lr100) < 0.15


class TestCheckpoint:
    def test_roundtrip_and_gc(self):
        tree = {"a": _randn(4, 8),
                "b": {"c": torch.arange(5),
                      "d": torch.ones(3, dtype=torch.bfloat16)},
                "opt": optim.AdamWState(torch.tensor(7, dtype=torch.int32),
                                        {"x": _randn(2)},
                                        {"x": torch.zeros(2).bfloat16()},
                                        {"x": torch.ones(2).bfloat16()})}
        with tempfile.TemporaryDirectory() as d:
            for step in (1, 2, 3, 4, 5):
                ckpt.save(d, step, tree, extras={"step": step}, keep=2)
            assert ckpt.latest_step(d) == 5
            assert len(os.listdir(d)) == 2       # keep=2 gc'd the rest
            got, extras = ckpt.restore(d, tree)
            assert extras["step"] == 5
            want = optim.tree_items(tree["b"]) + [(("a",), tree["a"])]
            for path, t in want:
                node = got
                for k in (path if path[0] == "a" else ("b",) + path):
                    node = node[k]
                assert node.dtype == t.dtype and torch.equal(node, t)
            assert isinstance(got["opt"], optim.AdamWState)
            assert int(got["opt"].step) == 7
            assert got["opt"].v["x"].dtype == torch.bfloat16
            assert torch.equal(got["opt"].master["x"], tree["opt"].master["x"])

    def test_corruption_detected(self):
        tree = {"a": _randn(16)}
        with tempfile.TemporaryDirectory() as d:
            path = ckpt.save(d, 1, tree)
            fn = os.path.join(path, "arrays.npz")
            data = bytearray(open(fn, "rb").read())
            data[-20] ^= 0xFF
            open(fn, "wb").write(bytes(data))
            with pytest.raises(Exception):
                ckpt.restore(d, tree)

    def test_restore_falls_back_to_newest_intact(self):
        tree = {"a": _randn(16)}
        with tempfile.TemporaryDirectory() as d:
            for step in (1, 2, 3):
                ckpt.save(d, step, tree, extras={"step": step}, keep=5)
            fn = os.path.join(d, "step_00000003", "arrays.npz")
            data = bytearray(open(fn, "rb").read())
            data[-20] ^= 0xFF
            open(fn, "wb").write(bytes(data))
            partial = os.path.join(d, "step_00000004")
            os.makedirs(partial)
            with open(os.path.join(partial, "MANIFEST.json"), "w") as f:
                f.write("{}")
            with pytest.warns(UserWarning, match="skipping damaged"):
                got, extras = ckpt.restore(d, tree)
            assert extras["step"] == 2
            assert torch.equal(got["a"], tree["a"])
            with pytest.raises(Exception):
                ckpt.restore(d, tree, step=3)

    def test_latest_step_tolerates_malformed_names(self):
        tree = {"a": _randn(4)}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 7, tree, extras={"step": 7})
            os.makedirs(os.path.join(d, "step_junk"))
            os.makedirs(os.path.join(d, "step_"))
            assert ckpt.latest_step(d) == 7
            _, extras = ckpt.restore(d, tree)
            assert extras["step"] == 7
            ckpt.save(d, 8, tree, keep=1)
            assert ckpt.latest_step(d) == 8


def _failure_recovery(arch):
    """The reference's failure-recovery run: a node failure at step 9
    (restart from the step-8 checkpoint) and an SDC alarm at 18."""
    cfg = tsmoke(tget(arch))
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=30,
                         ckpt_dir=d, ckpt_every=4, sdc_check_every=9)
        inj = FailureInjector({9: "node", 18: "sdc"})
        tr = Trainer(cfg, tc, injector=inj, global_batch=2, seq_len=16,
                     device="cpu")
        out = tr.run(22)
        assert out["final_step"] == 22
        assert out["restarts"] == 1
        assert out["sdc_alarms"] == [18]
        assert [h["step"] for h in out["history"]][:9] == list(range(9))


class TestFaultTolerance:
    def test_failure_recovery_end_to_end(self):
        _failure_recovery("qwen3-14b")

    def test_failure_recovery_end_to_end_qwen1_5_4b(self):
        """The reference's own case: smoke qwen1.5-4b (MHA, QKV bias)."""
        _failure_recovery("qwen1.5-4b")

    def test_node_failure_without_a_checkpoint_starts_over(self):
        cfg = tsmoke(tget("qwen3-14b"))
        tc = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=10)
        tr = Trainer(cfg, tc, injector=FailureInjector({3: "node"}),
                     global_batch=2, seq_len=8, device="cpu")
        out = tr.run(5)
        assert out["restarts"] == 1 and out["final_step"] == 5
        assert [h["step"] for h in out["history"]] == [0, 1, 2, 0, 1, 2,
                                                       3, 4]
        assert out["history"][0]["loss"] == out["history"][3]["loss"]

    def test_straggler_monitor(self):
        mon = StragglerMonitor(n_replicas=4, threshold=1.5)
        for step in range(10):
            slow = mon.observe(step, [1.0, 1.0, 1.0, 3.0])
        assert slow == [3]
        assert mon.events

    def test_data_determinism_across_restart(self):
        b1 = SyntheticCorpus(1000, 32, 4, seed=7).batch_at(13)
        b2 = SyntheticCorpus(1000, 32, 4, seed=7).batch_at(13)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_prefetcher(self):
        pf = Prefetcher(SyntheticCorpus(100, 8, 2).iterate(), depth=2)
        b = next(pf)
        assert b["tokens"].shape == (2, 8)
        pf.close()

    def test_injector_raises_once(self):
        inj = FailureInjector({2: "net"})
        inj.check(1)
        with pytest.raises(NodeFailure):
            inj.check(2)
        inj.check(2)


@pytest.mark.parametrize("vocab,seq,batch,seed,step",
                         [(512, 32, 4, 0, 0), (129280, 64, 2, 3, 17),
                          (1000, 8, 3, 7, 13)])
def test_batches_bitwise_equal_to_the_reference(vocab, seq, batch, seed,
                                                step):
    a = SyntheticCorpus(vocab, seq, batch, seed=seed).batch_at(step)
    b = JCorpus(vocab, seq, batch, seed=seed).batch_at(step)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


class TestConvergence:
    def test_loss_decreases_moe_mla_mtp(self):
        """The full paper stack (MLA + MoE + MTP + FP8) learns the
        synthetic bigram structure."""
        cfg = tsmoke(tget("deepseek-v3-671b"))
        tc = TrainConfig(peak_lr=3e-3, warmup=5, total_steps=40)
        tr = Trainer(cfg, tc, global_batch=4, seq_len=32, device="cpu")
        out = tr.run(30)
        h = out["history"]
        first = np.mean([x["loss"] for x in h[:3]])
        last = np.mean([x["loss"] for x in h[-3:]])
        assert last < first - 0.5, (first, last)
        assert {"loss", "ce", "mtp_loss", "aux_loss", "grad_norm", "lr",
                "blocks/drop_frac", "ntokens"} <= set(h[-1])


def test_train_checkpoint_serve_roundtrip():
    """Train the paper stack briefly, checkpoint, restore into the serving
    engine, decode: the full lifecycle."""
    cfg = tsmoke(tget("deepseek-v3-671b"))
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(peak_lr=2e-3, warmup=3, total_steps=20,
                         ckpt_dir=d, ckpt_every=8)
        tr = Trainer(cfg, tc, global_batch=2, seq_len=24, device="cpu")
        tr.run(16)
        assert ckpt.latest_step(d) == 16
        like = {"params": tr.model.init(0)}
        state, extras = ckpt.restore(d, like)
        assert extras["step"] == 16
        for path, t in optim.tree_items(state["params"]):
            node = tr.params
            for k in path:
                node = node[k]
            assert torch.equal(t, node), path
        eng = ServeEngine(cfg, params=state["params"], slots=2, max_len=48,
                          use_mtp=True, device="cpu")
        eng.add_request(Request(0, np.arange(6) % cfg.vocab_size,
                                max_new=8))
        eng.run_until_done()
        assert eng.stats["tokens"] >= 8


def test_meshed_training_waits_for_expert_parallelism():
    """Meshed training is ported (``tests/test_torch_train_mesh.py``); a
    ``ctx`` that is not a ParallelCtx is refused, and an unmeshed one is
    the single-device step."""
    from repro_torch.parallel.context import ParallelCtx
    cfg = tsmoke(tget("qwen3-14b"))
    with pytest.raises(TypeError, match="ParallelCtx"):
        Trainer(cfg, TrainConfig(), ctx=object(), device="cpu")
    with pytest.raises(TypeError, match="ParallelCtx"):
        make_train_step(Model(cfg, device="cpu"), TrainConfig(),
                        ctx=object())
    tr = Trainer(cfg, TrainConfig(), ctx=ParallelCtx(), global_batch=2,
                 seq_len=8, device="cpu")
    assert not tr.meshed and tr.run(1)["mesh_shape"] is None


def test_loss_refuses_prepared_weights():
    cfg = tsmoke(tget("deepseek-v3-671b"))
    m = Model(cfg, device="cpu")
    p = bridge.prepare_for_serving(m.init(0), cfg)
    batch = SyntheticCorpus(cfg.vocab_size, 8, 1).batch_at(0)
    with pytest.raises(ValueError, match="raw weights"):
        m.loss(p, batch)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="GPU"):
        Trainer(tsmoke(tget("qwen3-14b")), TrainConfig())


TRAJ_KW = dict(peak_lr=3e-3, warmup=2, total_steps=10)


@pytest.fixture(scope="module", params=["fp8", "nofp8"])
def trajectory(request):
    import dataclasses
    use_fp8 = request.param == "fp8"
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    cfg = dataclasses.replace(cfg, fp8=use_fp8)
    tcfg = dataclasses.replace(tcfg, fp8=use_fp8)
    jt = JTrainer(cfg, JTrainConfig(**TRAJ_KW), global_batch=4, seq_len=32)
    state0 = (jax.tree.map(np.asarray, jt.params),
              jax.tree.map(np.asarray, jt.opt_state))
    out = jt.run(5)
    return dict(tcfg=tcfg, state0=state0, history=out["history"],
                bias=np.asarray(jt.params["blocks"]["moe"]["bias"]),
                rtol=2e-3 if use_fp8 else 1e-5)


def test_trainer_trajectory_matches_jax(trajectory):
    tr = Trainer(trajectory["tcfg"], TrainConfig(**TRAJ_KW), global_batch=4,
                 seq_len=32, device="cpu")
    tr.params, tr.opt_state = bridge.train_state_from_jax(
        *trajectory["state0"])
    out = tr.run(5)
    assert out["final_step"] == 5 and out["restarts"] == 0
    assert len(out["history"]) == len(trajectory["history"]) == 5
    for a, b in zip(trajectory["history"], out["history"]):
        assert a["step"] == b["step"]
        assert abs(b["loss"] - a["loss"]) <= trajectory["rtol"] * abs(
            a["loss"]), (a["step"], a["loss"], b["loss"])
    np.testing.assert_array_equal(
        tr.params["blocks"]["moe"]["bias"].numpy(), trajectory["bias"])
    assert int(tr.opt_state.step) == 5
