"""The port's mesh path against the reference's *sharded* results (CPU).

The counterparts of the reference's four tests in
``tests/test_distributed.py``, each on the same mesh shape and at the
reference's bars.  The reference's results come from one JAX subprocess
with 8 fake host devices (``--xla_force_host_platform_device_count``, as
the reference's tests set it), which writes them and the seeded inputs to
an ``.npz``; the port runs in gloo ranks on the CPU, a process each
(``_torch_mesh_ranks``), from the same inputs (weights carried with
``interop``):

- the MoE's ``shard_map`` branch: dbrx and granite ``.smoke()`` (4
  experts; d_ff 192, since the smoke's 128 is no multiple of 3, which the
  reference's expert-TP ``shard_map`` refuses) on an expert-parallel mesh
  (data 2, model 2) and an expert-TP mesh (data 2, model 3), on the reference's random input and on a skewed
  one (every token's first choice expert 0), on which the sharded
  dispatch's per-shard capacity keeps tokens the local dispatch drops: the
  port's sharded result differs from its local one there, so the test
  tells the two semantics apart; 2e-4;
- the flash decode over a sequence-sharded cache: llama3-8b ``.smoke()``
  on (2, 2), the decoded position in each of the two shards in turn (in
  the first, the second shard holds no valid row: its partials are the
  neutral ones); logits 3e-4, cache 1e-5;
- the sharded train step on (2, 2) with 2 microbatches against the
  reference's sharded step: loss 5e-3, parameters rtol 2e-2 / atol 2e-3;
  its gradient: the global norm within 1e-4 (relative), the first moment
  after the step within 1e-4 of each leaf's largest magnitude;
- the pipeline: 2 stages, 4 microbatches, 1e-5.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_mesh_ranks as ranks

HERE = os.path.dirname(os.path.abspath(__file__))

MOE_ARCHS = ("dbrx-132b", "granite-moe-3b-a800m")
MOE_MESHES = {"ep": (2, 2), "tp": (2, 3)}
MOE_INPUTS = ("random", "skewed")
MOE_D_FF = 192
DECODE_PREFILLS = (8, 20)        # the decoded position: shard 0, shard 1
MOE_TOL = 2e-4
LOGITS_TOL, CACHE_TOL = 3e-4, 1e-5
LOSS_TOL, PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-2, 2e-3
GRAD_NORM_RTOL, MU_TOL = 1e-4, 1e-4
PIPE_TOL = 1e-5

ORACLE = """
import numpy as np, jax, jax.numpy as jnp
from _torch_mesh_ranks import flat
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.distributed.sharding import use_mesh
from repro.distributed.pipeline import pipeline_apply
from repro.launch.mesh import make_compat_mesh, make_host_mesh
from repro.models import build, moe as M
from repro.train import trainstep, optimizer as opt
out = {}
rng = np.random.default_rng(0)
f32 = np.float32
for arch in %(moe_archs)r:
    cfg = get_config(arch).smoke().scaled(d_ff=%(d_ff)r)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.d_ff
    p = {"router": rng.normal(size=(D, E)).astype(f32) * 0.1,
         "w1": rng.normal(size=(E, D, F)).astype(f32) * 0.05,
         "w3": rng.normal(size=(E, D, F)).astype(f32) * 0.05,
         "w2": rng.normal(size=(E, F, D)).astype(f32) * 0.05}
    u = rng.normal(size=D).astype(f32)
    u /= np.linalg.norm(u)
    p["router"][:, 0] += 4.0 * u
    hs = {"random": rng.normal(size=(4, 8, D)).astype(f32),
          "skewed": (rng.normal(size=(4, 64, D)) * 0.3 + u).astype(f32)}
    for k, v in p.items():
        out[f"{arch}/p/{k}"] = v
    for name, h in hs.items():
        out[f"{arch}/h/{name}"] = h
        out[f"{arch}/{name}/local"] = np.asarray(M.moe_fwd(p, h, cfg)[0])
        for mname, shape in %(moe_meshes)r.items():
            mesh = make_compat_mesh(shape, ("data", "model"))
            with use_mesh(mesh):
                o, aux = jax.jit(lambda p, h: M.moe_fwd(p, h, cfg))(p, h)
            out[f"{arch}/{name}/{mname}"] = np.asarray(o)
            out[f"{arch}/{name}/{mname}/aux"] = np.asarray(aux)

cfg = get_config("llama3-8b").smoke().scaled(cache_dtype="float32")
m = build(cfg)
params = m.init(jax.random.key(0))
out.update({"decode/params/" + k: v for k, v in flat(params).items()})
mesh = make_compat_mesh((2, 2), ("data", "model"))
for S in %(prefills)r:
    toks = rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32)
    logits, cache = m.prefill(params, {"tokens": jnp.asarray(toks)},
                              max_seq=32)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out[f"decode/{S}/tok"] = np.asarray(tok)
    for n in ("k", "v"):
        out[f"decode/{S}/cache/{n}"] = np.asarray(cache[n])
    with use_mesh(mesh):
        l_sm, c_sm = jax.jit(lambda p, c, t: m.decode_step(
            p, c, t, jnp.int32(S)))(params, cache, tok)
    out[f"decode/{S}/want/logits"] = np.asarray(l_sm)
    for n in ("k", "v"):
        out[f"decode/{S}/want/cache/{n}"] = np.asarray(c_sm[n])

cfg = get_config("qwen2.5-3b").smoke()
model = build(cfg)
shape = InputShape("tiny", 16, 8, "train")
params = model.init(jax.random.key(0))
out.update({"train/params/" + k: v for k, v in flat(params).items()})
batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)}
for k, v in batch.items():
    out[f"train/batch/{k}"] = v
mesh = make_host_mesh(data=2, model=2)
fn, in_sh, out_sh, _ = trainstep.build_train_step(model, shape, mesh,
                                                  microbatches=2)
p1, s1, m1 = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
    params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
out["train/want/loss"] = np.asarray(m1["loss"])
out["train/want/grad_norm"] = np.asarray(m1["grad_norm"])
out.update({"train/want/mu/" + k: v for k, v in flat(s1.mu).items()})
out.update({"train/want/params/" + k: v for k, v in flat(p1).items()})

mesh = make_compat_mesh((2,), ("pod",))
w = (rng.normal(size=(2, 16, 16)) * 0.5).astype(f32)
x = rng.normal(size=(4, 8, 16)).astype(f32)
got = pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"]), {"w": w}, x, mesh,
                     stages=2)
out.update({"pipe/w": w, "pipe/x": x, "pipe/want": np.asarray(got)})
np.savez(%(path)r, **out)
"""


def _split(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The reference's sharded results and the inputs, by name; the
    per-section ``.npz`` files the rank processes read."""
    tmp = tmp_path_factory.mktemp("mesh")
    path = str(tmp / "oracle.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([ranks.SRC, HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    code = ORACLE % dict(moe_archs=MOE_ARCHS, moe_meshes=MOE_MESHES,
                         d_ff=MOE_D_FF,
                         prefills=DECODE_PREFILLS, path=path)
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr[-4000:]
    d = dict(np.load(path))
    for sec in ("decode", "train", "pipe"):
        np.savez(tmp / f"{sec}.npz", **_split(d, sec + "/"))
    return tmp, d


@pytest.fixture(scope="module")
def moe_runs(oracle):
    tmp, _ = oracle
    return {(arch, mname): ranks.run(
        "moe", shape[0] * shape[1], tmp, npz=str(tmp / "oracle.npz"),
        arch=arch, d_ff=MOE_D_FF, mesh=shape, inputs=MOE_INPUTS)
        for arch in MOE_ARCHS for mname, shape in MOE_MESHES.items()}


@pytest.mark.parametrize("name", MOE_INPUTS)
@pytest.mark.parametrize("mname", sorted(MOE_MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_sharded_matches_reference_sharded(oracle, moe_runs, arch,
                                               mname, name):
    _, d = oracle
    want = d[f"{arch}/{name}/{mname}"]
    for r, got in enumerate(moe_runs[arch, mname]):
        np.testing.assert_allclose(got[f"{name}/sharded"].numpy(), want,
                                   rtol=MOE_TOL, atol=MOE_TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got[f"{name}/aux"]),
                                   float(d[f"{arch}/{name}/{mname}/aux"]),
                                   rtol=MOE_TOL, atol=MOE_TOL)
        np.testing.assert_allclose(got[f"{name}/local"].numpy(),
                                   d[f"{arch}/{name}/local"],
                                   rtol=MOE_TOL, atol=MOE_TOL)


@pytest.mark.parametrize("mname", sorted(MOE_MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_skewed_input_tells_sharded_from_local(oracle, moe_runs, arch,
                                                   mname):
    """On the skewed input the sharded dispatch keeps tokens the local one
    drops: the two results differ by far more than the bar (in both
    packages alike)."""
    _, d = oracle
    got = moe_runs[arch, mname][0]
    gap = np.abs(got["skewed/sharded"].numpy()
                 - got["skewed/local"].numpy()).max()
    ref_gap = np.abs(d[f"{arch}/skewed/{mname}"]
                     - d[f"{arch}/skewed/local"]).max()
    assert gap > 100 * MOE_TOL and ref_gap > 100 * MOE_TOL, (gap, ref_gap)


@pytest.fixture(scope="module")
def decode_run(oracle):
    tmp, _ = oracle
    return ranks.run("decode", 4, tmp, npz=str(tmp / "decode.npz"),
                     prefills=DECODE_PREFILLS)


@pytest.mark.parametrize("S", DECODE_PREFILLS)
def test_flash_decode_matches_reference_sharded(oracle, decode_run, S):
    _, d = oracle
    for r, got in enumerate(decode_run):
        np.testing.assert_allclose(got[f"{S}/logits"].numpy(),
                                   d[f"decode/{S}/want/logits"],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL,
                                   err_msg=f"rank {r}")
        for n in ("k", "v"):
            np.testing.assert_allclose(got[f"{S}/cache/{n}"].numpy(),
                                       d[f"decode/{S}/want/cache/{n}"],
                                       rtol=CACHE_TOL, atol=CACHE_TOL)


@pytest.fixture(scope="module")
def train_run(oracle):
    tmp, _ = oracle
    return ranks.run("train", 4, tmp, npz=str(tmp / "train.npz"))


def test_sharded_train_step_matches_reference_sharded(oracle, train_run):
    _, d = oracle
    want = _split(d, "train/want/params/")
    for r, got in enumerate(train_run):
        assert abs(float(got["loss"]) - float(d["train/want/loss"])) \
            < LOSS_TOL, (float(got["loss"]), float(d["train/want/loss"]))
        assert set(_split(got, "params/")) == set(want)
        for name, a in want.items():
            np.testing.assert_allclose(got[f"params/{name}"].numpy(), a,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"rank {r} {name}")


def test_sharded_train_step_gradient_matches_reference_sharded(oracle,
                                                               train_run):
    """The step's gradient itself: its global norm, and the first moment
    after the step (``(1 - b1) * g`` from zero moments), each leaf within
    ``MU_TOL`` of its largest magnitude.  The parameters move by ~lr = 3e-6
    at the first warm-up step, far inside their bar, so only these catch a
    wrong, partial or missing reduction of the gradient over the mesh."""
    _, d = oracle
    want = _split(d, "train/want/mu/")
    for r, got in enumerate(train_run):
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(d["train/want/grad_norm"]),
                                   rtol=GRAD_NORM_RTOL,
                                   err_msg=f"rank {r}")
        assert set(_split(got, "mu/")) == set(want)
        for name, a in want.items():
            np.testing.assert_allclose(
                got[f"mu/{name}"].numpy(), a, rtol=0,
                atol=MU_TOL * np.abs(a).max(), err_msg=f"rank {r} {name}")


def test_pipeline_matches_reference(oracle):
    tmp, d = oracle
    runs = ranks.run("pipeline", 2, tmp, npz=str(tmp / "pipe.npz"))
    for got in runs:
        np.testing.assert_allclose(got["out"].numpy(), d["pipe/want"],
                                   rtol=PIPE_TOL, atol=PIPE_TOL)
