"""The trainer's substrate in the port against the reference (CPU):
the data pipeline (``batch_at`` bit for bit), int8 gradient compression
(bit for bit on float32, with and without error feedback), checkpoints in
both directions (the reference's files restored by the port bit for bit,
float32 and bfloat16; the port's files byte-identical to the reference's
for the same trees; the reference's restore of a float32 port
checkpoint), ``latest_step`` past a half-written directory, and the loop's
resume and retry (the port of ``test_substrate.py::
test_loop_resume_and_retry``)."""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data import pipeline as ref_dpipe
from repro.distributed import compression as ref_comp
from repro.models import build as ref_build
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import pipeline as dpipe
from repro_torch.distributed import compression
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt


def bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or JAX / numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---- data -------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,vocab,S,B", [
    (0, 0, 256, 32, 8), (0, 7, 100, 16, 4), (3, 12345, 151936, 64, 2),
    (11, 2, 8192, 128, 8)])
def test_batch_at_equals_the_reference(seed, step, vocab, S, B):
    ref = ref_dpipe.batch_at(ref_dpipe.DataConfig(vocab, S, B, seed), step)
    got = dpipe.batch_at(dpipe.DataConfig(vocab, S, B, seed), step,
                         device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_extra_inputs_are_seeded_by_seed_and_step():
    cfg = get_config("whisper-small").smoke()
    a = dpipe.extra_inputs(cfg, 2, 0, 5, device="cpu")["frames"]
    b = dpipe.extra_inputs(cfg, 2, 0, 5, device="cpu")["frames"]
    c = dpipe.extra_inputs(cfg, 2, 0, 6, device="cpu")["frames"]
    assert a.shape == (2, cfg.num_frames, cfg.d_model)
    assert torch.equal(a, b) and not torch.equal(a, c)
    vlm = get_config("internvl2-76b")
    p = dpipe.extra_inputs(vlm, 1, 0, 0, device="cpu")["patches"]
    assert p.dtype == torch.bfloat16 and p.shape[1] == vlm.num_patches
    assert dpipe.extra_inputs(get_config("llama3-8b"), 2, 0, 0,
                              device="cpu") == {}


# ---- compression ------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((64, 33)) * 10).astype(np.float32),
            "b": {"c": (rng.standard_normal(17) * 1e-3).astype(np.float32),
                  "z": np.zeros(5, np.float32)}}


def _torch_tree(t):
    return L.tree_map(lambda a: torch.from_numpy(np.array(a)), t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_equals_the_reference(seed):
    x = _grads(seed)["a"]
    rq, rs = ref_comp.quantize(jnp.asarray(x))
    q, s = compression.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert bits(s).tobytes() == bits(rs).tobytes()
    np.testing.assert_array_equal(
        bits(compression.dequantize(q, s)),
        bits(ref_comp.dequantize(rq, rs)))


def test_compress_decompress_equals_the_reference():
    g = _grads(3)
    ref = ref_comp.compress_decompress(jax.tree.map(jnp.asarray, g))
    got = compression.compress_decompress(_torch_tree(g))
    for r, t in zip(jax.tree.leaves(ref), L.tree_leaves(got)):
        np.testing.assert_array_equal(bits(t), bits(r))


def test_error_feedback_equals_the_reference_over_steps():
    res = L.tree_map(lambda a: np.zeros_like(a), _grads(0))
    ref_res = jax.tree.map(jnp.asarray, res)
    res = _torch_tree(res)
    for step in range(5):
        g = _grads(10 + step)
        ref_g, ref_res = ref_comp.compress_decompress(
            jax.tree.map(jnp.asarray, g), ref_res)
        got_g, res = compression.compress_decompress(_torch_tree(g), res)
        for r, t in zip(jax.tree.leaves((ref_g, ref_res)),
                        L.tree_leaves({"g": got_g, "r": res})):
            np.testing.assert_array_equal(bits(t), bits(r))


# ---- checkpoints ------------------------------------------------------------

def _trees(dtype):
    """The reference's smoke qwen2.5-3b parameters in ``dtype`` and an
    optimizer state with nonzero moments and step 3, as (reference params,
    reference state, port params, port state)."""
    rcfg = ref_config("qwen2.5-3b").smoke().scaled(dtype=dtype)
    pcfg = get_config("qwen2.5-3b").smoke().scaled(dtype=dtype)
    rp = ref_build(rcfg).init(jax.random.key(0))
    rng = np.random.default_rng(1)
    noise = lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32))
    rs = ref_opt.OptState(step=jnp.int32(3), mu=jax.tree.map(noise, rp),
                          nu=jax.tree.map(lambda p: noise(p) ** 2, rp))
    pp = interop.model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, rp), device="cpu")
    ps = interop.opt_state_from_numpy(
        int(rs.step), jax.tree.map(np.asarray, rs.mu),
        jax.tree.map(np.asarray, rs.nu), device="cpu")
    return rp, rs, pp, ps


def _assert_trees_bitwise(ref_tree, port_tree):
    ref_leaves = jax.tree.leaves(ref_tree)
    port_leaves = ckpt._flatten_with_names(port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for r, (name, t) in zip(ref_leaves, port_leaves):
        assert tuple(t.shape) == tuple(np.shape(r)), name
        assert bits(t).dtype.itemsize == bits(r).dtype.itemsize, name
        np.testing.assert_array_equal(bits(t), bits(r), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    rp, rs, pp, ps = _trees(dtype)
    d = str(tmp_path / "ck")
    ref_ckpt.save(d, 7, rp, rs, extra={"loss": 1.5})
    like = L.tree_map(torch.zeros_like, pp)
    p2, s2, manifest = ckpt.restore(d, 7, like, opt.init(like))
    assert manifest["step"] == 7 and manifest["extra"] == {"loss": 1.5}
    assert int(s2.step) == 3 and s2.step.dtype == torch.int32
    _assert_trees_bitwise({"opt": rs, "params": rp},
                          {"params": p2, "opt": s2})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_files_equal_the_references(tmp_path, dtype):
    rp, rs, pp, ps = _trees(dtype)
    a, b = tmp_path / "ref", tmp_path / "port"
    ref_ckpt.save(str(a), 5, rp, rs, extra={"loss": 2.0})
    ckpt.save(str(b), 5, pp, ps, extra={"loss": 2.0})
    da, db = a / "step_00000005", b / "step_00000005"
    files = sorted(os.listdir(da))
    assert files == sorted(os.listdir(db))
    match, mismatch, errors = filecmp.cmpfiles(da, db, files, shallow=False)
    assert not mismatch and not errors and match == files


def test_reference_restores_a_float32_port_checkpoint(tmp_path):
    rp, rs, pp, ps = _trees("float32")
    d = str(tmp_path / "ck")
    ckpt.save(d, 9, pp, ps)
    p2, s2, manifest = ref_ckpt.restore(
        d, 9, jax.tree.map(jnp.zeros_like, rp), ref_opt.init(rp))
    assert manifest["step"] == 9 and int(s2.step) == 3
    _assert_trees_bitwise({"opt": s2, "params": p2},
                          {"params": pp, "opt": ps})


def test_checkpoint_round_trip_in_the_port_keeps_every_type(tmp_path):
    tree = {"bf": torch.randn(3, 4).to(torch.bfloat16),
            "f16": torch.randn(5).to(torch.float16),
            "f32": torch.randn(2, 2), "i": torch.arange(4, dtype=torch.int32)}
    state = opt.init(tree)
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, tree, state)
    like = L.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), tree)
    got, st, _ = ckpt.restore(d, 1, like, opt.init(like), device="cpu")
    for k in tree:
        assert got[k].dtype == tree[k].dtype and torch.equal(got[k], tree[k])
    assert int(st.step) == 0


def test_latest_step_ignores_half_written(tmp_path):
    d = tmp_path / "ck"
    assert ckpt.latest_step(str(d)) is None
    _, _, pp, ps = _trees("float32")
    ckpt.save(str(d), 4, pp, ps)
    os.makedirs(d / ".tmp_step_00000008")
    os.makedirs(d / "step_00000009")          # no manifest: half-written
    assert ckpt.latest_step(str(d)) == 4
    assert ref_ckpt.latest_step(str(d)) == 4


# ---- the loop ---------------------------------------------------------------

def test_loop_resume_and_retry(tmp_path):
    from repro_torch.train.loop import LoopConfig, train
    cfg = get_config("qwen2.5-3b").smoke()
    model = build(cfg)
    shape = InputShape("tiny", 16, 4, "train")
    lc = LoopConfig(total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path / "ck"),
                    log_every=100)
    st1 = train(model, shape, None, loop_cfg=lc, device="cpu")
    assert st1.step == 4 and all(np.isfinite(st1.losses))
    # resume: raise total steps; loop must restart from step 4
    lc2 = LoopConfig(total_steps=6, ckpt_every=2,
                     ckpt_dir=str(tmp_path / "ck"), log_every=100)
    st2 = train(model, shape, None, loop_cfg=lc2, device="cpu")
    assert st2.step == 6 and st2.restarts >= 1 and len(st2.losses) == 2

    # transient failure injection: retried, training completes
    calls = {"n": 0}

    def injector(step, attempt):
        if step == 6 and attempt == 0:
            calls["n"] += 1
            raise RuntimeError("injected preemption")
    lc3 = LoopConfig(total_steps=7, ckpt_every=10,
                     ckpt_dir=str(tmp_path / "ck"), log_every=100,
                     retry_backoff_s=0.01)
    st3 = train(model, shape, None, loop_cfg=lc3, fail_injector=injector,
                device="cpu")
    assert calls["n"] == 1 and st3.step == 7


def test_loop_raises_a_failure_past_its_retries(tmp_path):
    """An error that persists (an out-of-memory error is a RuntimeError)
    is retried ``max_retries`` times and then raised, never swallowed."""
    from repro_torch.train.loop import LoopConfig, train
    model = build(get_config("qwen2.5-3b").smoke())
    attempts = []

    def injector(step, attempt):
        attempts.append(attempt)
        raise torch.OutOfMemoryError("injected out of memory")
    lc = LoopConfig(total_steps=2, ckpt_dir=str(tmp_path / "ck"),
                    max_retries=2, retry_backoff_s=0.001)
    with pytest.raises(torch.OutOfMemoryError):
        train(model, InputShape("tiny", 16, 2, "train"), None, loop_cfg=lc,
              fail_injector=injector, device="cpu")
    assert attempts == [0, 1, 2]
    assert not os.path.exists(tmp_path / "ck")


def _fail_one_update(monkeypatch, at):
    """Make the ``at``-th leaf update of ``optimizer.apply_`` in the run
    (counted from 0 over every step) raise an out-of-memory error, once;
    returns the count of updates called."""
    calls = {"n": 0}
    prepare = opt._prepare

    def patched(cfg, grads, state):
        metrics, update, step = prepare(cfg, grads, state)

        def failing(*leaf):
            calls["n"] += 1
            if calls["n"] - 1 == at:
                raise torch.OutOfMemoryError("injected out of memory")
            return update(*leaf)
        return metrics, failing, step
    monkeypatch.setattr(opt, "_prepare", patched)
    return calls


@pytest.mark.parametrize("after_write", [False, True])
def test_a_failure_inside_the_optimizer_never_applies_a_step_twice(
        tmp_path, monkeypatch, after_write):
    """The step writes the parameters and moments in place, leaf by leaf.
    An out-of-memory error in the second step's first leaf update (nothing
    written yet) is retried, and the run ends bit for bit where a run
    without it ends; one in its second leaf update (the first leaf already
    written) is not retried: the loop raises ``PartialUpdateError`` and
    the last checkpoint stays the first step's."""
    from repro_torch.train.loop import LoopConfig, train
    model = build(get_config("qwen2.5-3b").smoke())
    shape = InputShape("tiny", 16, 2, "train")
    n_leaves = len(L.tree_leaves(model.param_structs()))
    lc = lambda d: LoopConfig(total_steps=3, ckpt_every=1,
                              ckpt_dir=str(tmp_path / d), log_every=100,
                              retry_backoff_s=0.001)
    clean = train(model, shape, None, loop_cfg=lc("clean"), device="cpu")
    calls = _fail_one_update(monkeypatch, n_leaves + int(after_write))
    if after_write:
        with pytest.raises(opt.PartialUpdateError) as err:
            train(model, shape, None, loop_cfg=lc("failed"), device="cpu")
        assert isinstance(err.value.__cause__, torch.OutOfMemoryError)
        assert calls["n"] == n_leaves + 2           # no second attempt
        assert ckpt.latest_step(str(tmp_path / "failed")) == 1
        return
    st = train(model, shape, None, loop_cfg=lc("failed"), device="cpu")
    assert st.restarts == 1 and st.losses == clean.losses
    assert calls["n"] == 3 * n_leaves + 1
    like = model.param_structs()
    got, want = (ckpt.restore(str(tmp_path / d), 3, like, opt.init(like),
                              device="cpu")[:2] for d in ("failed", "clean"))
    for tree in (lambda t: t[0], lambda t: t[1].mu, lambda t: t[1].nu):
        for a, b in zip(L.tree_leaves(tree(got)), L.tree_leaves(tree(want))):
            assert torch.equal(a, b)
    assert int(got[1].step) == int(want[1].step) == 3
