"""The port's train step against the reference's (CPU, float32 smoke
configs, the reference's weights carried with
``interop.model_params_from_numpy``; the shared harness and its
tolerances are ``_torch_train_parity``).

The dense, MoE and SSM families' loss, every gradient (against
``jax.value_and_grad(model.loss)``) and one ``build_train_step`` step;
the ``microbatches=2`` and ``compress_grads=True`` branches against the
reference's jitted step; the mesh refusal, ``default_microbatches``, the
prefill and decode steps and ``interop.opt_state_from_numpy``.  The
hybrid, encoder-decoder and VLM families and remat are
``test_torch_trainstep_families.py``, the differentiable attention
``test_torch_flash_attention_grad.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
import _torch_train_parity as tp
from repro.train import optimizer as ref_opt
from repro.train import trainstep as ref_ts
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import layers as L
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

B, S = tp.B, tp.S


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
def test_loss_gradients_and_one_step_match_the_reference(family):
    tp.check_family(tp.FAMILIES[family])


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_microbatched_step_matches_the_reference(family):
    """Two microbatches: gradients added in float32, divided by two, the
    mean of the two losses."""
    tp.check_step(tp.run(tp.FAMILIES[family], microbatches=2))


def test_compressed_step_matches_the_reference():
    """int8 compression before the optimizer (bit for bit on equal input:
    ``test_torch_train_substrate.py``); here each moment within one
    quantization level of the reference's."""
    tp.check_step(tp.run(tp.FAMILIES["dense"], compress=True),
                  compressed=True)


def test_microbatched_gradients_are_float32(monkeypatch):
    """bf16 parameters: one batch gives bf16 gradients, two microbatches
    float32 sums (the reference's float32 accumulator)."""
    rm, rp, pm, pp = parity.models("qwen2.5-3b", dtype="bfloat16")
    _, pb = parity.inputs(rm.cfg, B, S, seed=1)
    seen = []
    apply_ = opt.apply_

    def spy(cfg, params, grads, state):
        seen.append({g.dtype for g in L.tree_leaves(grads)})
        return apply_(cfg, params, grads, state)

    monkeypatch.setattr(opt, "apply_", spy)
    for k in (1, 2):
        step = ts.build_train_step(pm, InputShape("t", S, B, "train"),
                                   microbatches=k)[0]
        step(L.tree_map(torch.clone, pp), opt.init(pp), pb)
    assert seen == [{torch.bfloat16}, {torch.float32}]


def test_a_mesh_is_refused():
    _, _, pm, _ = parity.models("qwen2.5-3b")
    shape = InputShape("t", S, B, "train")
    for build in (ts.build_train_step, ts.build_prefill_step,
                  ts.build_decode_step):
        with pytest.raises(NotImplementedError, match="distributed"):
            build(pm, shape, object())


@pytest.mark.parametrize("arch,shape,axes", [
    ("llama3-8b", "train_4k", {"data": 8, "model": 4}),
    ("dbrx-132b", "train_4k", {"pod": 2, "data": 16, "model": 8}),
    ("granite-moe-3b-a800m", "train_4k", {"data": 4, "model": 1}),
    ("qwen2.5-3b", "train_4k", {"data": 256})])
def test_default_microbatches_matches_the_reference(arch, shape, axes):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro_torch.configs import SHAPES
    mesh = types.SimpleNamespace(
        axis_names=tuple(axes),
        devices=types.SimpleNamespace(shape=tuple(axes.values())))
    want = ref_ts.default_microbatches(ref_config(arch), REF_SHAPES[shape],
                                       mesh)
    assert ts.default_microbatches(get_config(arch), SHAPES[shape],
                                   mesh) == want
    assert ts.default_microbatches(get_config(arch), SHAPES[shape],
                                   None) == 1


def test_prefill_and_decode_steps_and_their_stand_ins():
    rm, rp, pm, pp = parity.models("qwen2.5-3b")
    shape = InputShape("p", 16, 2, "prefill")
    prefill, *rest = ts.build_prefill_step(pm, shape)
    assert rest == [None, None, ()]
    decode, *rest = ts.build_decode_step(pm, shape)
    assert rest == [None, None, (1,)]
    toks = torch.arange(16, dtype=torch.int32).view(2, 8)
    logits, cache = prefill(pp, {"tokens": toks})
    assert cache["k"].shape[2] == 16 and not logits.requires_grad
    logits2, _ = decode(pp, cache, toks[:, :1], 8)
    assert logits2.shape == (2, 1, pm.cfg.padded_vocab)
    c, t, p = ts.decode_inputs(pm, shape)
    rc, rt, rpos = ref_ts.decode_inputs(rm, shape)
    for a, b in zip(L.tree_leaves(c), jax.tree.leaves(rc)):
        assert a.is_meta and tuple(a.shape) == b.shape
    assert t.is_meta and tuple(t.shape) == rt.shape and t.dtype == torch.int32
    assert p.is_meta and p.shape == () and p.dtype == torch.int32


def test_opt_state_from_numpy_carries_the_reference_state():
    rm, rp, pm, pp = parity.models("qwen2.5-3b")
    rs = ref_opt.init(rp)
    rs = rs._replace(step=jnp.int32(7),
                     mu=jax.tree.map(lambda x: x + 1.5, rs.mu))
    st = interop.opt_state_from_numpy(
        int(rs.step), jax.tree.map(np.asarray, rs.mu),
        jax.tree.map(np.asarray, rs.nu), device="cpu")
    assert int(st.step) == 7 and st.step.dtype == torch.int32
    for r, g in zip(jax.tree.leaves(rs.mu), L.tree_leaves(st.mu)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError):
        interop.opt_state_from_numpy(0, {"a": np.zeros(2, np.float32)},
                                     {"b": np.zeros(2, np.float32)},
                                     device="cpu")


def test_apply_in_place_equals_apply_bitwise(monkeypatch):
    """``apply_`` writes ``apply``'s values into the tensors it was given,
    bit for bit, also where it updates a leaf in slices of its leading
    axis (a nested tree, a stacked leaf, a scalar leaf)."""
    monkeypatch.setattr(opt, "APPLY_CHUNK", 7 * 64)
    rng = np.random.default_rng(9)
    draw = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    params = {"stack": draw(5, 13, 64), "b": {"w": draw(53, 64),
                                              "s": draw()}}
    grads = tree_map(lambda p: draw(*p.shape), params)
    cfg = opt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    want_p, want_s, want_m = opt.apply(cfg, params, grads, opt.init(params))
    got = tree_map(torch.clone, params)
    state = opt.init(got)
    leaves = lambda *trees: [x for t in trees for x in tree_leaves(t)]
    ids = [id(t) for t in leaves(got, state.mu)]
    got_p, got_s, got_m = opt.apply_(cfg, got, grads, state)
    assert [id(t) for t in leaves(got_p, got_s.mu)] == ids
    for a, b in zip(leaves(got_p, got_s.mu, got_s.nu),
                    leaves(want_p, want_s.mu, want_s.nu)):
        assert torch.equal(a, b)
    assert int(got_s.step) == int(want_s.step) == 1
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])

