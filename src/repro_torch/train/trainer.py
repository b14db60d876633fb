"""Training orchestration — port of ``repro.train.trainer``: the train
step (loss and grads -> AdamW -> router-bias balancing),
checkpoint/restart, failure recovery, elastic re-meshing, straggler
monitoring and the SDC guard.

``make_train_step(model, tc, ctx)`` is the one step function for both
regimes:

* **single device** (``ctx`` None or unmeshed): ``Model.loss`` on the
  full batch, local MoE, plain AdamW.
* **meshed** (``ctx.mesh`` set; explicit SPMD, one process a mesh
  position): this rank's shards of the parameters and of the optimizer
  state by the train rules (``parallel/sharding.train_pspecs``: FSDP x
  TP), each layer's data cut (over ``data``, or over the pair ``("pod",
  "data")`` on a multi-pod mesh) gathered as the model reaches it and its
  gradient reduce-scattered in the backward (``sharding.Zero3``); the
  loss over TWO anti-phase microbatches of this data rank's rows
  (``Model.loss_dual``, paper §2.3.1) with the MoE through ``ep_flat`` /
  ``ep_dedup`` at the ctx's wire, their all-to-alls differentiated
  (``parallel/collectives``); the gradients of leaves that replicate over
  the data axes all-reduced over them; grad-norm clipping on
  ``collectives.sharded_global_norm``; and the router-bias update on the
  EP path's load, averaged over the mesh.

PyTorch runs the step eagerly: the parameters are the optimizer's leaves
and are updated in place (``optimizer.update``), so the state lives once
on the device (10 bytes a parameter, plus the bf16 gradients while a step
runs). On the card the FP8 linears run their three GEMMs through the
``fp8_gemm`` kernel when ``cfg.fp8_impl == "pallas"``; attention and the
experts run their plain versions (a kernel launched under autograd
raises: ``kernels/registry.py``).

The ``Trainer`` on a ``NodeFailure`` re-meshes onto the survivors
(``launch/mesh.survivor_mesh``: the first half of the pod axis, else of
the data axis; the other ranks leave) and restores the last checkpoint
re-sharded onto the new mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import routing
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models.api import Model
from repro_torch.models.param import init_params, param_structs
from repro_torch.parallel import collectives
from repro_torch.parallel import context as pctx_mod
from repro_torch.parallel import sharding
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


# families the dual-microbatch step supports (no encoder/vision memory
# side inputs to thread through the joint layers)
_DUAL_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def dual_microbatch_engaged(cfg: ModelConfig, ctx: pctx_mod.ParallelCtx,
                            batch_size: int) -> bool:
    """Whether the meshed step runs the dual anti-phase microbatch path
    for this (config, ctx, global batch). Single source for the step
    function and the trainer's degradation warning."""
    return (ctx.mesh is not None and ctx.microbatches >= 2
            and cfg.family in _DUAL_FAMILIES
            and batch_size % (2 * ctx.dp_size) == 0)


def _check_ctx(ctx) -> pctx_mod.ParallelCtx:
    if ctx is None:
        return pctx_mod.ParallelCtx()
    if not isinstance(ctx, pctx_mod.ParallelCtx):
        raise TypeError(f"ctx must be a ParallelCtx, not {type(ctx)!r}")
    return ctx


def _meshed_checks(model: Model, ctx: pctx_mod.ParallelCtx, pspecs) -> None:
    """The meshed step's conditions; each unmet one raises (no fallback)."""
    cfg = model.cfg
    if ctx.ep_ftp:
        raise NotImplementedError(
            "ep_ftp in training: the expert-FF cut is the decode's, as in "
            "the reference's trainer")
    if cfg.moe and ctx.model_size > 1 and not ctx.ep_enabled:
        raise ValueError(
            "an MoE config under a model axis trains its experts split over "
            "it: set moe_impl to 'ep_flat' or 'ep_dedup'")
    if cfg.fp8:
        sharding.check_fp8_train_cuts(model.specs(), pspecs, ctx.mesh)


def _tree_of(items, values) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for (path, _), v in zip(items, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _reduce_over_data(grads, specs, group, axes) -> None:
    """All-reduce over the data axes ``axes`` (their group ``group``; fp32,
    one buffer) the gradients of the leaves that replicate over them; the
    data-cut leaves had theirs summed by their gathers' reduce-scatters.
    In place in the list ``grads``."""
    idx = [i for i, (g, s) in enumerate(zip(grads, specs))
           if g is not None and sharding.data_dim(s, axes) is None]
    if not idx:
        return
    flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
    flat = collectives.all_reduce(flat, group)
    o = 0
    for i in idx:
        g = grads[i]
        grads[i] = flat[o:o + g.numel()].reshape(g.shape).to(g.dtype)
        o += g.numel()


def make_train_step(model: Model, tc: TrainConfig, ctx=None):
    """Returns ``step_fn(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``, updating ``params`` and ``opt_state`` in place.
    The router bias is set out of band (not by Adam), as DeepSeek-V3's
    aux-loss-free balancing does, and its master copy kept in step.

    ``ctx``: the parallel context (a ``ParallelCtx``). Unmeshed (or None)
    it is the single-device step. Meshed, ``params`` and ``opt_state``
    are this rank's shards (``sharding.train_pspecs``, ``shard_state``)
    and ``batch`` this data rank's rows (``sharding.batch_pspec``); the
    loss and its metrics are the global ones on every rank."""
    pctx = _check_ctx(ctx)
    meshed = pctx.mesh is not None
    cfg = model.cfg
    pspecs = None
    if meshed:
        pspecs = sharding.train_pspecs(pctx.mesh, model.specs(), cfg=cfg)
        _meshed_checks(model, pctx, pspecs)

    def step_fn(params, opt_state, batch, step):
        items = optim.tree_items(params)
        leaves = [t for _, t in items]
        B = batch["tokens"].shape[0] * pctx.dp_size
        dual = dual_microbatch_engaged(cfg, pctx, B)
        # meshed: this step's ZeRO-3 plan rides on the ctx; unmeshed the
        # ctx still scopes the step (its remat policy)
        ctx = (dataclasses.replace(pctx, zero3=sharding.Zero3(
            pctx.mesh, pspecs, pctx.dp_axes)) if meshed else pctx)
        for t in leaves:
            t.requires_grad_(True)
        try:
            with pctx_mod.use(ctx):
                if dual:
                    # each data rank halves its own rows, interleaved as
                    # the reference splits the global batch: the loss is
                    # a mean, invariant to which rows land in which half
                    bA = {k: v[0::2] for k, v in batch.items()}
                    bB = {k: v[1::2] for k, v in batch.items()}
                    loss, metrics = model.loss_dual(params, bA, bB)
                else:
                    loss, metrics = model.loss(params, batch)
                grads = list(torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))
        finally:
            for t in leaves:
                t.requires_grad_(False)
        gnorm = None
        if meshed:
            specs = [sharding.at_path(pspecs, path) for path, _ in items]
            if pctx.dp_group is not None:
                _reduce_over_data(grads, specs, pctx.dp_group, pctx.dp_axes)
        gtree = _tree_of(items, grads)
        del grads
        if meshed:
            # the clip scale from an explicit sum over the mesh, the same
            # bits on every rank
            gnorm = collectives.sharded_global_norm(gtree, pctx.mesh, pspecs)
        lr = sched.warmup_cosine(step, peak_lr=tc.peak_lr, warmup=tc.warmup,
                                 total=tc.total_steps)
        params, opt_state, ostats = optim.update(
            gtree, opt_state, params, lr=lr,
            weight_decay=tc.weight_decay, clip_norm=tc.clip_norm,
            grad_norm=gnorm)
        del gtree
        # --- aux-loss-free router-bias balancing (paper T2/V3) ----------
        # under a mesh the per-expert load arrives averaged over the mesh
        # (the EP path's _pmean), so every rank sets the same bias
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


class Trainer:
    """Trainer with restart and elastic-recovery semantics (the
    reference's ``Trainer``).

    ``ctx`` (a ``ParallelCtx``; default the ambient one) selects the
    regime. Meshed, every rank of the mesh builds its own ``Trainer``
    with the same arguments: it draws its shards of the parameters (each
    leaf drawn whole from the seed and cut, so the shards tile the tree
    one device draws), takes its data rank's rows of each global batch,
    and runs the meshed step. On a ``NodeFailure`` it re-meshes onto the
    survivors (the pod axis halved, else the data axis); a dropped rank
    leaves (``run`` returns with ``left`` true) and the survivors restore
    the last checkpoint re-sharded onto the survivor mesh. An SDC alarm
    restores the same way.

    ``device``: where the model trains, the card unless the caller passes
    ``device="cpu"`` (without a card it raises). Parameters are drawn
    from ``tc.seed`` by the port's generator (``models/param.py``), not
    with the reference's bits; a test that compares the two trainers
    sets the state from ``bridge.train_state_from_jax`` (``load_state``
    under a mesh).
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 data: Optional[SyntheticCorpus] = None,
                 injector: Optional[fault_mod.FailureInjector] = None,
                 global_batch: int = 8, seq_len: int = 64, ctx=None,
                 device=None):
        self.cfg = cfg
        self.tc = tc
        self.ctx = _check_ctx(pctx_mod.get() if ctx is None else ctx)
        self.model = Model(cfg, device)
        self.device = self.model.device
        self.data = data or SyntheticCorpus(cfg.vocab_size, seq_len,
                                            global_batch, seed=tc.seed)
        self.injector = injector
        self.sdc = fault_mod.SDCGuard()
        self.straggler = fault_mod.StragglerMonitor(
            n_replicas=self._n_replicas())
        self.restarts = 0
        self.left = False
        self.history: list = []
        self.last_device_checksums: Dict[int, int] = {}
        self._init_state()

    # -- mesh plumbing -------------------------------------------------------
    @property
    def meshed(self) -> bool:
        return self.ctx.mesh is not None

    def _n_replicas(self) -> int:
        return self.ctx.dp_size if self.meshed else 1

    def state_pspecs(self):
        """``{"params": pspecs, "opt": AdamWState of pspecs}`` on the
        current mesh (the reference's ``train_state_shardings``)."""
        p = sharding.train_pspecs(self.ctx.mesh, self.model.specs(),
                                  cfg=self.cfg)
        return {"params": p, "opt": optim.AdamWState(sharding.P(), p, p, p)}

    def load_state(self, params, opt_state=None):
        """Set the state from global (logical) trees, this rank's cut of
        them under a mesh; ``opt_state`` None: a fresh one."""
        move = functools.partial(optim.tree_map,
                                 lambda t: t.to(self.device, copy=True))
        if self.meshed:
            ps = self.state_pspecs()
            params = sharding.shard_tree(params, ps["params"], self.ctx.mesh)
            if opt_state is not None:
                opt_state = sharding.shard_state(opt_state, ps["params"],
                                                 self.ctx.mesh)
        self.params = move(params)
        self.opt_state = (optim.init(self.params) if opt_state is None else
                          type(opt_state)(opt_state.step.to(self.device),
                                          move(opt_state.master),
                                          move(opt_state.m),
                                          move(opt_state.v)))

    def _remesh_on_failure(self):
        """Shrink to the survivor mesh (the model/EP axis kept); a rank
        off it leaves."""
        if not self.meshed:
            return
        from repro_torch.launch.mesh import survivor_mesh
        new_mesh = survivor_mesh(self.ctx.mesh)
        if new_mesh is not self.ctx.mesh:
            self.ctx = dataclasses.replace(self.ctx, mesh=new_mesh)
        self.left = new_mesh.rank is None
        self.straggler = fault_mod.StragglerMonitor(
            n_replicas=self._n_replicas())

    # -- state ---------------------------------------------------------------
    def _init_state(self, restore: bool = False):
        tc = self.tc
        ps = self.state_pspecs() if self.meshed else None
        if restore and tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir):
            p = param_structs(self.model.specs())
            like = {"params": p, "opt": optim.AdamWState(
                torch.empty((), dtype=torch.int32, device="meta"),
                optim.tree_map(lambda t: t.float(), p),
                optim.tree_map(lambda t: t.bfloat16(), p),
                optim.tree_map(lambda t: t.bfloat16(), p))}
            state, extras = ckpt.restore(
                tc.ckpt_dir, like, device=self.device, pspecs=ps,
                mesh=self.ctx.mesh if self.meshed else None)
            self.params = state["params"]
            self.opt_state = state["opt"]
            self.step = int(extras["step"])
        else:
            placement = (ps["params"], self.ctx.mesh) if self.meshed else None
            self.params = init_params(self.model.specs(), tc.seed,
                                      self.device, placement)
            self.opt_state = optim.init(self.params)
            self.step = 0
        self._step_fn = make_train_step(self.model, tc,
                                        self.ctx if self.meshed else None)
        # the first steps after a (re)start pay first-run allocation and
        # kernel builds: not steady-state timings, kept out of the EWMA
        self._warmup_steps = 2
        # surface silent degradations instead of leaving the user to
        # believe the requested overlap is active
        gb = getattr(self.data, "batch", None)
        if gb is None:   # duck-typed corpus: only batch_at is guaranteed
            gb = self.data.batch_at(0)["tokens"].shape[0]
        if (self.meshed and self.ctx.microbatches >= 2
                and not dual_microbatch_engaged(self.cfg, self.ctx, gb)):
            warnings.warn(
                f"dual-microbatch overlap requested but not engaged: "
                f"family={self.cfg.family} needs to be one of "
                f"{_DUAL_FAMILIES} and global batch {gb} must be a "
                f"multiple of 2*dp={2 * self.ctx.dp_size}; running the "
                f"single-batch step", stacklevel=2)

    def _save(self):
        if not self.tc.ckpt_dir:
            return
        extras = {"step": self.step}
        state = {"params": self.params, "opt": self.opt_state}
        if not self.meshed:
            ckpt.save(self.tc.ckpt_dir, self.step, state, extras=extras,
                      keep=self.tc.keep_ckpts)
            return
        mesh = self.ctx.mesh
        extras["mesh"] = {"axes": list(mesh.axis_names),
                          "shape": [mesh.shape[a] for a in mesh.axis_names]}
        ckpt.save(self.tc.ckpt_dir, self.step, state, extras=extras,
                  keep=self.tc.keep_ckpts, mesh=mesh,
                  pspecs=self.state_pspecs())

    def run(self, steps: int) -> Dict[str, Any]:
        target = self.step + steps
        while self.step < target and not self.left:
            try:
                self._run_until(target)
            except fault_mod.NodeFailure:
                # failure: re-mesh on the survivors + restore the last
                # checkpoint, re-sharded onto the shrunken mesh
                self.restarts += 1
                self._remesh_on_failure()
                if not self.left:
                    self._init_state(restore=True)
        return {"final_step": self.step, "restarts": self.restarts,
                "history": self.history,
                "sdc_alarms": self.sdc.alarms,
                "straggler_events": self.straggler.events,
                "mesh_shape": (tuple(self.ctx.mesh.shape[a]
                                     for a in self.ctx.mesh.axis_names)
                               if self.meshed else None),
                "left": self.left}

    # -- measurement ---------------------------------------------------------
    def _observe_step(self, metrics, t0: float) -> None:
        """Per-replica step times: meshed, each rank's own completion
        time gathered over the mesh (``fault.replica_step_times``);
        unmeshed, the step's wall time (the read of the loss waits for
        the device)."""
        if self.meshed:
            times = fault_mod.replica_step_times(
                metrics["loss"], self.ctx.mesh, self.ctx.dp_axes, t0)
        else:
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
        """Checksums whose disagreement flags silent corruption.

        Meshed: every fully replicated parameter (norms, router biases,
        any leaf no rule cuts) holds the same bits on every rank by
        construction, so each rank's checksum of its replicated copies,
        gathered over the mesh (one per rank), is a real cross-replica
        comparison (paper §6.1; the cut leaves are covered at checkpoint
        granularity by the manifest CRCs). With nothing replicated, two
        read-backs of each rank's shards. Unmeshed: the on-device
        checksum against a simulated second replica. The injector flips
        one."""
        if self.meshed:
            mesh = self.ctx.mesh
            specs = dict(optim.tree_items(self.state_pspecs()["params"]))
            leaves = [t for path, t in optim.tree_items(self.params)
                      if all(e is None for e in specs[path])]
            reads = 1 if leaves else 2
            leaves = leaves or [t for _, t in optim.tree_items(self.params)]
            checks = []
            for _ in range(reads):
                c, = collectives.device_checksums(leaves).values()
                mine = torch.tensor([c], dtype=torch.int64)
                for a in reversed(mesh.axis_names):
                    mine = (collectives.all_gather(mine, mesh.groups[a])
                            if mesh.shape[a] > 1 else mine)
                checks.append([int(c) for c in mine.reshape(-1)])
            self.last_device_checksums = dict(enumerate(checks[-1]))
            checks = (checks[0] if reads == 1 else
                      [functools.reduce(lambda a, b: a ^ b, r, 0)
                       for r in checks])
        else:
            c = int(collectives.tree_checksum(self.params))
            checks = [c, c]
        if self.injector and self.injector.corrupts(self.step):
            checks[1] ^= 0xDEAD
            self.injector.fired.add(self.step)
        return checks

    def _local_batch(self, batch):
        """This data rank's rows of a global batch (``sharding.
        batch_pspec``: the batch axis over the data axes when it divides,
        else every rank all of it)."""
        if not self.meshed:
            return batch
        mesh = self.ctx.mesh
        B = batch["tokens"].shape[0]
        spec = sharding.batch_pspec(mesh, B, self.ctx.dp_axes)
        if spec[0] is None:
            return batch
        n, i = self.ctx.dp_size, self.ctx.dp_index
        per = B // n
        return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}

    def _run_until(self, target: int):
        while self.step < target:
            if self.injector:
                self.injector.check(self.step)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in self._local_batch(
                    self.data.batch_at(self.step)).items()}
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
