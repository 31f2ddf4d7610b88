"""Tensor parallelism of the train step and of the SSD mixers on a mesh
(CPU, gloo ranks).

A train step (``trainstep.build_train_step``) keeps each dense weight's
"model" shards of the reference's "tp" axes, the SSD mixers' "ssm_heads"
and "ssm_inner" among them, and takes the reference's sequence-parallel
residual where the sequence divides the model axis
(``sharding.TensorParallel``).  Each case is held to the reference's
*sharded* step: one JAX subprocess with 8 fake host devices runs the
reference's ``build_train_step`` (and for mamba2-130m
``build_prefill_step`` / ``build_decode_step``) under their in and out
shardings, from weights carried with ``interop``, at
``tests/test_torch_distributed.py``'s bars: loss 5e-3, parameters rtol
2e-2 / atol 2e-3, the gradient norm 1e-4 relative, the first moment after
the step 1e-4 of each leaf's largest magnitude; logits 3e-4, cache 1e-5.

- llama3-8b ``.smoke()`` on (data 1, model 2) and on (1, 4), where its 2
  kv heads do not divide the axis;
- heads that are not whole on a rank (2 heads, 1 kv head, model 4);
- a sequence (10) that does not divide the model axis (4): the residual
  stays whole;
- mamba2-130m ``.smoke()`` (8 SSD heads, d_inner 128) on (2, 2): the train
  step, the prefill and a decode step;
- jamba ``.smoke()`` on (1, 2) (SSD, attention and MoE positions);
- granite ``.smoke()`` on (2, 2), whose MoE takes the sequence split.

The layers a rank was handed in the train step are its shards: on (1, 4)
a quarter of wq, wo, w1, w2, w3 and of the vocabulary's table, and a
quarter of the sequence at each block (half of mamba2-130m's wz, wx, wdt
and wo on (2, 2)).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_mesh_ranks as ranks

HERE = os.path.dirname(os.path.abspath(__file__))
LOSS_TOL, PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-2, 2e-3
GRAD_NORM_RTOL, MU_TOL = 1e-4, 1e-4
LOGITS_TOL, CACHE_TOL = 3e-4, 1e-5
LLAMA, MAMBA = "llama3-8b", "mamba2-130m"

# (name, arch, config overrides, mesh, (B, S), decoded positions)
CASES = {
    2: (("m2", LLAMA, {}, (1, 2), (4, 16), ()),
        ("jamba", "jamba-v0.1-52b", {}, (1, 2), (2, 16), ())),
    4: (("m4", LLAMA, {}, (1, 4), (4, 16), ()),
        ("part_heads", LLAMA, dict(num_heads=2, num_kv_heads=1), (1, 4),
         (4, 16), ()),
        ("seq_whole", LLAMA, {}, (1, 4), (4, 10), ()),
        ("mamba", MAMBA, {}, (2, 2), (4, 16), (16, 17)),
        ("granite", "granite-moe-3b-a800m", {}, (2, 2), (4, 16), ())),
}
ALL = [c for cs in CASES.values() for c in cs]
SERVE = [c for c in ALL if c[5]]
# the shapes a rank's layers are handed in a train step (case, leaf, shape)
HELD = (("m4", "wq", (64, 16)), ("m4", "wo", (16, 64)),
        ("m4", "w1", (64, 32)), ("m4", "w2", (32, 64)),
        ("m4", "w3", (64, 32)), ("m4", "embedding", (64, 64)),
        ("m4", "attention_fwd/h", (4, 4, 64)),
        ("m4", "mlp_fwd/h", (4, 4, 64)),
        ("seq_whole", "attention_fwd/h", (4, 10, 64)),
        ("mamba", "wz", (64, 64)), ("mamba", "wx", (64, 64)),
        ("mamba", "wdt", (64, 4)), ("mamba", "wo", (64, 64)),
        ("mamba", "gate_norm", (64,)),
        ("mamba", "ssd_block_fwd/h", (2, 8, 64)))

ORACLE = """
import numpy as np, jax, jax.numpy as jnp
from _torch_mesh_ranks import flat
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.mesh import make_compat_mesh
from repro.models import build
from repro.train import trainstep, optimizer as opt
out = {}
rng = np.random.default_rng(0)
for name, arch, over, shape, (B, S), positions in %(cases)r:
    cfg = get_config(arch).smoke().scaled(**over)
    m = build(cfg)
    params = m.init(jax.random.key(0))
    out.update({name + "/params/" + k: v for k, v in flat(params).items()})
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    for k, v in batch.items():
        out[f"{name}/batch/{k}"] = v
    mesh = make_compat_mesh(shape, ("data", "model"))
    fn, in_sh, out_sh, _ = trainstep.build_train_step(
        m, InputShape("t", S, B, "train"), mesh, microbatches=1)
    p1, s1, m1 = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
        params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    out[name + "/want/loss"] = np.asarray(m1["loss"])
    out[name + "/want/grad_norm"] = np.asarray(m1["grad_norm"])
    out.update({name + "/want/mu/" + k: v for k, v in flat(s1.mu).items()})
    out.update({name + "/want/params/" + k: v for k, v in flat(p1).items()})
    if not positions:
        continue
    pf, in_sh, out_sh, _ = trainstep.build_prefill_step(
        m, InputShape("p", S, B, "prefill"), mesh)
    logits, cache = jax.jit(pf, in_shardings=in_sh, out_shardings=out_sh)(
        params, {"tokens": jnp.asarray(batch["tokens"])})
    out[name + "/prefill/logits"] = np.asarray(logits)
    for n, c in cache.items():
        out[name + "/cache/" + n] = np.asarray(c)
    tok = np.asarray(jnp.argmax(logits[:, -1], -1)[:, None]).astype(np.int32)
    out[name + "/tok"] = tok
    dec, in_sh, out_sh, donate = trainstep.build_decode_step(
        m, InputShape("d", S, B, "decode"), mesh)
    step = jax.jit(dec, in_shardings=in_sh, out_shardings=out_sh,
                   donate_argnums=donate)
    for pos in positions:
        c0 = {n: jnp.array(out[name + "/cache/" + n]) for n in cache}
        l, c = step(params, c0, jnp.asarray(tok), jnp.int32(pos))
        out[f"{name}/{pos}/logits"] = np.asarray(l)
        for n in c:
            out[f"{name}/{pos}/cache/{n}"] = np.asarray(c[n])
np.savez(%(path)r, **out)
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    path = str(tmp / "oracle.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([ranks.SRC, HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    code = ORACLE % dict(cases=ALL, path=path)
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr[-4000:]
    return tmp, dict(np.load(path))


@pytest.fixture(scope="module")
def runs(oracle):
    tmp, _ = oracle
    out = {}
    for world, cases in CASES.items():
        got = ranks.run("tp_train", world, tmp,
                        npz=str(tmp / "oracle.npz"), cases=cases)
        for name, *_ in cases:
            out[name] = got
    return out


def _split(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", ALL, ids=[c[0] for c in ALL])
def test_train_step_matches_reference_sharded(oracle, runs, case):
    name = case[0]
    _, d = oracle
    want = _split(d, f"{name}/want/params/")
    for r, got in enumerate(runs[name]):
        loss, ref = float(got[f"{name}/loss"]), float(d[f"{name}/want/loss"])
        assert abs(loss - ref) < LOSS_TOL, (r, loss, ref)
        assert set(_split(got, f"{name}/params/")) == set(want)
        for leaf, a in want.items():
            np.testing.assert_allclose(got[f"{name}/params/{leaf}"].numpy(),
                                       a, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"rank {r} {leaf}")


@pytest.mark.parametrize("case", ALL, ids=[c[0] for c in ALL])
def test_train_step_gradient_matches_reference_sharded(oracle, runs, case):
    """The gradient itself: its global norm, and the first moment after
    the step (``(1 - b1) * g`` from zero moments), each leaf within
    ``MU_TOL`` of its largest magnitude (the parameters move by ~lr at the
    first warm-up step, far inside their bar)."""
    name = case[0]
    _, d = oracle
    want = _split(d, f"{name}/want/mu/")
    for r, got in enumerate(runs[name]):
        np.testing.assert_allclose(float(got[f"{name}/grad_norm"]),
                                   float(d[f"{name}/want/grad_norm"]),
                                   rtol=GRAD_NORM_RTOL, err_msg=f"rank {r}")
        assert set(_split(got, f"{name}/mu/")) == set(want)
        for leaf, a in want.items():
            np.testing.assert_allclose(
                got[f"{name}/mu/{leaf}"].numpy(), a, rtol=0,
                atol=MU_TOL * np.abs(a).max(), err_msg=f"rank {r} {leaf}")


def _close(got, want, tol, msg):
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("case", SERVE, ids=[c[0] for c in SERVE])
def test_ssd_serve_steps_match_reference_sharded(oracle, runs, case):
    """mamba2-130m's prefill (logits, the SSD states of this rank's heads
    gathered whole) and a decode step from the reference's prefill cache at
    each position (logits, the conv and SSD states)."""
    name = case[0]
    _, d = oracle
    for r, got in enumerate(runs[name]):
        _close(got[f"{name}/prefill/logits"], d[f"{name}/prefill/logits"],
               LOGITS_TOL, f"rank {r}")
        for n in ("conv", "ssm"):
            _close(got[f"{name}/prefill/cache/{n}"], d[f"{name}/cache/{n}"],
                   CACHE_TOL, f"rank {r} prefill {n}")
        for pos in case[5]:
            _close(got[f"{name}/{pos}/logits"], d[f"{name}/{pos}/logits"],
                   LOGITS_TOL, f"rank {r} {pos}")
            for n in ("conv", "ssm"):
                _close(got[f"{name}/{pos}/cache/{n}"],
                       d[f"{name}/{pos}/cache/{n}"], CACHE_TOL,
                       f"rank {r} {pos} {n}")


@pytest.mark.parametrize("name,leaf,shape", HELD,
                         ids=[f"{n}-{leaf}" for n, leaf, _ in HELD])
def test_train_step_layers_hold_their_shards(runs, name, leaf, shape):
    """The weights and the residual a rank's layers were handed in the
    train step: its "model" shards, and its slice of the sequence where
    the sequence divides the model axis (whole where it does not)."""
    for r, got in enumerate(runs[name]):
        assert tuple(got[f"{name}/held/{leaf}"].tolist()) == shape, (r, leaf)
