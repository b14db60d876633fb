"""PyTorch port: the vision family — llama-3.2-vision-90b (``vision_pattern``
steps: one gated cross-attention block over the request's patch
embeddings, then ``cross_attn_every - 1`` self-attention blocks, whose
parameters and rings nest one stacked axis deeper) — against the JAX
package on the CPU, at smoke width in fp32 on ``bridge.params_from_jax``
weights whose gates ``gate_attn`` and ``gate_mlp`` are drawn non-zero
(harness: ``_torch_crossattn.py``; at their "zeros" init a cross layer
adds nothing, and a broken cross-attention would pass every check).

* The cross block (``tanh(gate)`` times the attention and the FFN)
  within 1e-5 of the reference's.
* At full size, nothing allocated: every parameter as the reference's
  (the gates' "zeros" init among them), ``count_params`` 87 666 794 536.
* Bucketed prefill logits with every cache leaf (the ``(n, k, B, T, ...)``
  rings and the ``memory`` leaf) and three decode steps: 1e-5.
* Greedy streams equal the JAX engine's on the dense engine, on the
  default path and on the kernel path (``flash_prefill`` for the self
  blocks' prefill; dense GQA decode has no kernel in the reference).
* The batch axes: 2 for the nested rings, 0 for the memory; a decode
  keeps every cache leaf's tensor.
* ``Model.loss`` within 1e-5, every gradient within 1e-4, the gates'
  among them.
* Refusals as the reference's: ``paged=True`` and ``decode_overlap=True``
  (``ValueError``). A mesh raises A.13 (``test_torch_archs_encdec.py``).
"""
import numpy as np
import pytest
import torch

import _torch_archs as h
import _torch_crossattn as x
from repro.models import transformer as jtfm
from repro.models.api import Model as JModel
from repro_torch.models import transformer
from repro_torch.models.api import Model
from repro_torch.models.param import layer

CASE = "vision"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cross_block_matches_the_reference():
    import jax
    import jax.numpy as jnp
    jp, _ = x.weights(CASE)
    cfg, tcfg = x.configs(CASE)
    rng = np.random.default_rng(4)
    B, S, T = 2, 6, cfg.num_patches
    h_ = (0.5 * rng.normal(size=(B, S, cfg.d_model))).astype(np.float32)
    mem = x.extras(cfg, 2, batch=B)["patch_embeds"]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    mp = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jpl = jax.tree.map(lambda a: a[1], jp["pat"]["cross"])
    tpl = layer(x.port_params(CASE)["pat"]["cross"], 1)
    assert float(tpl["gate_attn"]) != 0 and float(tpl["gate_mlp"]) != 0
    ref = jtfm.cross_block_apply(
        jpl, jnp.asarray(h_), cfg, dict(positions=jnp.asarray(pos),
                                        memory=jnp.asarray(mem),
                                        mem_positions=jnp.asarray(mp)))[0]
    ours = transformer.cross_block_apply(
        tpl, torch.from_numpy(h_), tcfg,
        dict(positions=torch.from_numpy(pos), memory=torch.from_numpy(mem),
             mem_positions=torch.from_numpy(mp)))[0]
    assert x.rel(ours.numpy(), ref) <= 1e-5
    assert x.rel(h_, ref) > 1e-2             # the layer adds something


def test_param_shapes_and_counts_equal_the_reference():
    x.check_counts(CASE, 87_666_794_536)
    from repro_torch.configs.base import get_config as tget
    from repro_torch.models.api import count_params
    from repro.models.api import count_params as jcount_params
    from repro.configs.base import get_config
    # the card's cut: two whole patterns at published widths
    assert count_params(tget("llama-3.2-vision-90b", num_layers=10)) == \
        jcount_params(get_config("llama-3.2-vision-90b", num_layers=10))


def test_prefill_cache_and_decode_logits_match_jax():
    x.check_logits(CASE)


@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["default", "kernel"])
def test_streams_equal_jax(kernel_path, monkeypatch):
    ref = x.streams(CASE, False, "dense", kernel_path)
    calls = h.counted_ops(monkeypatch)
    ours = x.streams(CASE, True, "dense", kernel_path)
    assert ours == ref
    assert all(len(s) == x.MAX_NEW for s in ours["streams"])
    cfg = x.configs(CASE)[1]
    n_self = cfg.num_layers // cfg.cross_attn_every * (
        cfg.cross_attn_every - 1)
    # the self blocks' prefill only: the cross blocks pass no impl, and the
    # dense ring's decode has no kernel
    assert calls == ({"flash_prefill": len(x.LENGTHS) * n_self}
                     if kernel_path else {})


def test_batch_axes_and_decode_keeps_every_cache_leaf():
    eng = x.engine(CASE, True, "dense")
    axes = eng.model.cache_batch_axes(2, 64)
    jaxes = JModel(x.configs(CASE)[0]).cache_batch_axes(2, 64)
    assert h.flat(axes) == h.flat(jaxes)
    assert eng.model._dense_cache_axes(eng.cache) == axes
    before = {p: t.data_ptr() for p, t in h.flat(eng.cache).items()}
    reqs = x.requests(True, eng.cfg.vocab_size)
    x.submit_all(eng, reqs)
    eng.run_until_done()
    assert {p: t.data_ptr() for p, t in h.flat(eng.cache).items()} == before


def test_loss_and_every_gradient_leaf_match_jax():
    mags = x.check_loss_and_grads(CASE)
    assert mags[("pat", "cross", "gate_attn")] > 0
    assert mags[("pat", "cross", "gate_mlp")] > 0


def test_paged_raises_the_reference_value_error():
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.serve.engine import ServeEngine
    cfg, tcfg = x.configs(CASE)
    with pytest.raises(ValueError) as want:
        JServeEngine(cfg, params=x.weights(CASE)[0], paged=True, **x.KW)
    with pytest.raises(ValueError) as got:
        ServeEngine(tcfg, paged=True, device="cpu", **x.KW)
    assert str(got.value) == str(want.value)
    assert not Model(tcfg, device="meta").supports_paged()
    assert not JModel(cfg).supports_paged()


def _overlap(port):
    eng = x.engine(CASE, port, decode_overlap=True)
    req = x.requests(port, eng.cfg.vocab_size)[0]
    eng.submit(req, x.extras(eng.cfg, 0))
    with pytest.raises(ValueError) as info:
        eng.run_until_done()
    return str(info.value)


def test_decode_overlap_raises_the_reference_value_error():
    assert _overlap(True) == _overlap(False)
