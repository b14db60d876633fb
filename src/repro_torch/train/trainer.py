"""Training orchestration — port of ``repro.train.trainer``, single
device: the train step (loss and grads -> AdamW -> router-bias
balancing), checkpoint/restart, failure recovery, straggler monitoring and
the SDC guard.

``make_train_step(model, tc)`` is the reference's unmeshed step:
``Model.loss`` on the full batch, local MoE, plain AdamW. The meshed step
(sharded state, the dual anti-phase microbatches of ``loss_dual``, the
EP dispatch, ``sharded_global_norm``) and the elastic re-mesh on a node
failure wait for ROADMAP.md, A.8: a ``ctx=`` raises, as
``ServeEngine(ctx=)`` does.

PyTorch runs the step eagerly: the parameters are the optimizer's leaves
and are updated in place (``optimizer.update``), so the state lives once
on the device (10 bytes a parameter, plus the bf16 gradients while a step
runs). On the card the FP8 linears run their three GEMMs through the
``fp8_gemm`` kernel when ``cfg.fp8_impl == "pallas"``; attention and the
experts run their plain versions (a kernel launched under autograd
raises: ``kernels/registry.py``).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import routing
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.device import torch_dtype
from repro_torch.models.api import Model
from repro_torch.models.param import ParamSpec
from repro_torch.parallel import collectives
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault as fault_mod
from repro_torch.train import optimizer as optim
from repro_torch.train import schedule as sched


@dataclasses.dataclass
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    bias_update_rate: float = 1e-3        # aux-loss-free balancing (V3)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    sdc_check_every: int = 0              # 0 = off
    seed: int = 0


def _meshed_waits(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md, A.8")


def make_train_step(model: Model, tc: TrainConfig, ctx=None):
    """Returns ``step_fn(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``, updating ``params`` and ``opt_state`` in place.
    The router bias is set out of band (not by Adam), as DeepSeek-V3's
    aux-loss-free balancing does, and its master copy kept in step."""
    if ctx is not None:
        raise _meshed_waits("make_train_step(ctx=): the meshed train step")
    cfg = model.cfg

    def step_fn(params, opt_state, batch, step):
        items = optim.tree_items(params)
        leaves = [t for _, t in items]
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        gtree: Dict[str, Any] = {}
        for (path, _), g in zip(items, grads):
            node = gtree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = g
        del grads
        lr = sched.warmup_cosine(step, peak_lr=tc.peak_lr, warmup=tc.warmup,
                                 total=tc.total_steps)
        params, opt_state, ostats = optim.update(
            gtree, opt_state, params, lr=lr,
            weight_decay=tc.weight_decay, clip_norm=tc.clip_norm)
        del gtree
        # --- aux-loss-free router-bias balancing (paper T2/V3) ----------
        if cfg.moe and cfg.moe.router_bias:
            with torch.no_grad():
                for seg in model.segments:
                    key = f"{seg.name}/load_layers"
                    if key in metrics and "moe" in params[seg.name]:
                        bias = params[seg.name]["moe"]["bias"]
                        new_bias = routing.update_bias(
                            bias, metrics[key], tc.bias_update_rate)
                        bias.copy_(new_bias)
                        opt_state.master[seg.name]["moe"]["bias"].copy_(
                            new_bias.float())
        metrics = {k: v for k, v in metrics.items()
                   if not k.endswith("load_layers")}
        metrics.update(ostats)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step_fn


def _meta_like(spec_tree):
    """Structure of a parameter tree as meta tensors (nothing allocated)."""
    if isinstance(spec_tree, ParamSpec):
        return torch.empty(spec_tree.shape,
                           dtype=torch_dtype(spec_tree.dtype), device="meta")
    return {k: _meta_like(v) for k, v in spec_tree.items()}


class Trainer:
    """Single-device trainer with restart semantics (the reference's
    ``Trainer`` unmeshed). On a ``NodeFailure`` it restores the newest
    intact checkpoint (or starts over from the seed without one) and goes
    on; an SDC alarm restores the same way.

    ``device``: where the model trains, the card unless the caller passes
    ``device="cpu"`` (without a card it raises). Parameters are drawn
    from ``tc.seed`` by the port's generator (``models/param.py``), not
    with the reference's bits; a test that compares the two trainers
    sets ``params`` and ``opt_state`` from ``bridge.train_state_from_jax``.
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 data: Optional[SyntheticCorpus] = None,
                 injector: Optional[fault_mod.FailureInjector] = None,
                 global_batch: int = 8, seq_len: int = 64, ctx=None,
                 device=None):
        if ctx is not None:
            raise _meshed_waits("Trainer(ctx=): meshed training")
        self.cfg = cfg
        self.tc = tc
        self.model = Model(cfg, device)
        self.device = self.model.device
        self.data = data or SyntheticCorpus(cfg.vocab_size, seq_len,
                                            global_batch, seed=tc.seed)
        self.injector = injector
        self.sdc = fault_mod.SDCGuard()
        self.straggler = fault_mod.StragglerMonitor(n_replicas=1)
        self.restarts = 0
        self.history: list = []
        self._step_fn = make_train_step(self.model, tc)
        self._init_state()

    # -- state ---------------------------------------------------------------
    def _init_state(self, restore: bool = False):
        tc = self.tc
        if restore and tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir):
            p = _meta_like(self.model.specs())
            like = {"params": p, "opt": optim.AdamWState(
                torch.empty((), dtype=torch.int32, device="meta"),
                optim.tree_map(lambda t: t.float(), p),
                optim.tree_map(lambda t: t.bfloat16(), p),
                optim.tree_map(lambda t: t.bfloat16(), p))}
            state, extras = ckpt.restore(tc.ckpt_dir, like,
                                         device=self.device)
            self.params = state["params"]
            self.opt_state = state["opt"]
            self.step = int(extras["step"])
        else:
            self.params = self.model.init(tc.seed)
            self.opt_state = optim.init(self.params)
            self.step = 0
        # the first steps after a (re)start pay first-run allocation and
        # kernel builds: not steady-state timings, kept out of the EWMA
        self._warmup_steps = 2

    def _save(self):
        if self.tc.ckpt_dir:
            ckpt.save(self.tc.ckpt_dir, self.step,
                      {"params": self.params, "opt": self.opt_state},
                      extras={"step": self.step}, keep=self.tc.keep_ckpts)

    def run(self, steps: int) -> Dict[str, Any]:
        target = self.step + steps
        while self.step < target:
            try:
                self._run_until(target)
            except fault_mod.NodeFailure:
                # failure: restore the last checkpoint and go on
                self.restarts += 1
                self.straggler = fault_mod.StragglerMonitor(n_replicas=1)
                self._init_state(restore=True)
        return {"final_step": self.step, "restarts": self.restarts,
                "history": self.history,
                "sdc_alarms": self.sdc.alarms,
                "straggler_events": self.straggler.events,
                "mesh_shape": None}

    # -- measurement ---------------------------------------------------------
    def _observe_step(self, metrics, t0: float) -> None:
        """The step's wall time (the single process is the only
        replica); the read of the loss waits for the device."""
        float(metrics["loss"])
        times = [time.perf_counter() - t0]
        if self._warmup_steps > 0:
            self._warmup_steps -= 1
            if self.injector and self.injector.slow_replica(
                    self.step) is not None:
                warnings.warn(f"slow-replica injection at step {self.step} "
                              f"falls in the warmup window and is not "
                              f"observed", stacklevel=2)
            return
        slow = (self.injector.slow_replica(self.step)
                if self.injector else None)
        if slow is not None and slow < len(times):
            times[slow] *= self.injector.slow_factor
        self.straggler.observe(self.step, times)

    def _sdc_checksums(self) -> list:
        """The on-device parameter checksum against a simulated second
        replica (bit-identical here), as the reference's unmeshed guard;
        the injector flips one."""
        c = int(collectives.tree_checksum(self.params))
        checks = [c, c]
        if self.injector and self.injector.corrupts(self.step):
            checks[1] ^= 0xDEAD
            self.injector.fired.add(self.step)
        return checks

    def _run_until(self, target: int):
        while self.step < target:
            if self.injector:
                self.injector.check(self.step)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch_at(self.step).items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch, self.step)
            self._observe_step(metrics, t0)
            metrics = {k: (float(v) if v.dim() == 0 else
                           v.detach().cpu().numpy())
                       for k, v in metrics.items()}
            self.history.append({"step": self.step, **{
                k: v for k, v in metrics.items() if np.ndim(v) == 0}})
            self.step += 1
            if self.tc.sdc_check_every and \
                    self.step % self.tc.sdc_check_every == 0:
                if not self.sdc.check(self.step, self._sdc_checksums()):
                    self._init_state(restore=True)    # restore-on-SDC
                    continue
            if self.tc.ckpt_dir and self.step % self.tc.ckpt_every == 0:
                self._save()
