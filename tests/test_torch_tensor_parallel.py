"""Tensor parallelism of the mesh's steps (CPU).

A step (``trainstep.build_prefill_step`` / ``build_decode_step`` /
``build_train_step``) keeps each dense weight's "model" shards of the
reference's "tp" axes and computes this rank's part of every product
(``sharding.TensorParallel``), as GSPMD partitions the reference's:

- **Work a device**, the op counter against the reference's HLO
  (``_torch_tp_counts``, ``InputShape("tiny", 64, 8, kind)``): per-device
  FLOPs of llama3-8b ``.smoke()``'s decode step on (data 2, model 4) and
  (2, 8), of its prefill and train step on (2, 4), and of mamba2-130m
  ``.smoke()``'s train and decode steps on (2, 4) within ``FLOPS_TOL`` of
  the reference's; the decode's HBM bytes at most ``DECODE_HBM_MAX`` times
  the reference's.  The prefill and the train step on (2, 8) are held to
  ``PREFILL_2X8_TOL``: llama's 4 heads do not divide the model axis, so two
  ranks attend with the head their columns fall in (and a prefill's norms
  run on the whole sequence, where GSPMD also splits the sequence).  HBM
  and collective bytes are printed as ratios.  The values of the train
  step on a mesh are held to the reference's sharded step in
  ``tests/test_torch_tensor_parallel_train.py``.
- **Values**, gloo ranks against the reference's sharded steps (one JAX
  subprocess with 8 fake host devices; the in and out shardings of the
  reference's step builders), at ``tests/test_torch_distributed.py``'s bars
  (logits 3e-4, cache 1e-5): the prefill's logits and cache, and a decode
  step from the reference's prefill cache at each position:

  - llama3-8b ``.smoke()`` on (1, 2) and (2, 2), a cache of 32 positions
    sequence-sharded, the decoded position in each shard;
  - kv heads (2) that do not divide the model axis (4): each rank's q head
    meets its kv head of the whole K/V;
  - heads that are not whole on a rank (2 heads, 1 kv head, model 4);
  - a cache whose sequence does not divide the model axis: its kv heads
    over "model" (31 positions, model 2), or whole (30, model 4), the
    decode's plain route;
  - granite's attention blocks (and its MoE) on (2, 2).

- **Memory**: inside a decode layer on (1, 4) each rank holds a quarter of
  wq, wo, w1, w2, w3 and of the vocabulary's tables.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_mesh_ranks as ranks
import _torch_tp_counts as counts

HERE = os.path.dirname(os.path.abspath(__file__))
FLOPS_TOL = 0.10
PREFILL_2X8_TOL = 0.30
DECODE_HBM_MAX = 2.0
LOGITS_TOL, CACHE_TOL = 3e-4, 1e-5
B, PROMPT = 4, 8

# (name, arch, config overrides, mesh, max_seq, decoded positions)
LLAMA = "llama3-8b"
F32 = {"cache_dtype": "float32"}
CASES = {
    2: (("m2", LLAMA, F32, (1, 2), 32, (8, 20)),
        ("kvshard", LLAMA, F32, (1, 2), 31, (8,))),
    4: (("d2m2", LLAMA, F32, (2, 2), 32, (8, 20)),
        ("kv_apart", LLAMA, F32, (1, 4), 32, (8, 20)),
        ("part_heads", LLAMA, dict(F32, num_heads=2, num_kv_heads=1),
         (1, 4), 32, (8, 20)),
        ("whole_cache", LLAMA, F32, (1, 4), 30, (8,)),
        ("granite", "granite-moe-3b-a800m", F32, (2, 2), 32, (8, 20))),
}
ALL = [c for cs in CASES.values() for c in cs]
# the weights a decode layer holds on (1, 4): a quarter of each
HELD = {"wq": (64, 64), "wo": (64, 64), "w1": (64, 128), "w2": (128, 64),
        "w3": (64, 128), "embedding": (256, 64), "unembed": (64, 256)}

ORACLE = """
import numpy as np, jax, jax.numpy as jnp
from _torch_mesh_ranks import flat
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.mesh import make_compat_mesh
from repro.models import build
from repro.train import trainstep
out = {}
rng = np.random.default_rng(0)
for name, arch, over, shape, max_seq, positions in %(cases)r:
    cfg = get_config(arch).smoke().scaled(**over)
    m = build(cfg)
    params = m.init(jax.random.key(0))
    out.update({name + "/params/" + k: v for k, v in flat(params).items()})
    toks = rng.integers(0, cfg.vocab_size, (%(B)r, %(P)r)).astype(np.int32)
    out[name + "/toks"] = toks
    mesh = make_compat_mesh(shape, ("data", "model"))
    pf, in_sh, out_sh, _ = trainstep.build_prefill_step(
        m, InputShape("p", max_seq, %(B)r, "prefill"), mesh)
    logits, cache = jax.jit(pf, in_shardings=in_sh, out_shardings=out_sh)(
        params, {"tokens": jnp.asarray(toks)})
    out[name + "/prefill/logits"] = np.asarray(logits)
    for n, c in cache.items():
        out[name + "/cache/" + n] = np.asarray(c)
    tok = np.asarray(jnp.argmax(logits[:, -1], -1)[:, None]).astype(np.int32)
    out[name + "/tok"] = tok
    dec, in_sh, out_sh, donate = trainstep.build_decode_step(
        m, InputShape("d", max_seq, %(B)r, "decode"), mesh)
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


# the serve cells of llama3-8b, and the train and Mamba cells
SERVE = [(k, m) for a, k, m in counts.CELLS
         if a == counts.LLAMA and k != "train"]
TRAIN = [c for c in counts.CELLS if c[0] != counts.LLAMA or c[1] == "train"]


@pytest.fixture(scope="module")
def op_counts():
    ref, port = counts.reference_counts(), counts.port_counts()
    for (arch, kind, mesh), r, p in zip(counts.CELLS, ref, port):
        print(f"{arch} {kind} {mesh}: port / reference " + ", ".join(
            f"{k} {p[k] / r[k]:.3f}" for k in counts.KEYS))
    return {cell: (r, p) for cell, r, p in zip(counts.CELLS, ref, port)}


def _flops_within(ref, port, tol):
    assert abs(port["flops"] / ref["flops"] - 1) <= tol, (port, ref)
    assert port["ici_bytes"] > 0 and port["static_collective_count"] > 0


@pytest.mark.parametrize("kind,mesh", SERVE)
def test_per_device_flops_match_reference_hlo(op_counts, kind, mesh):
    ref, port = op_counts[counts.LLAMA, kind, mesh]
    _flops_within(ref, port, PREFILL_2X8_TOL
                  if (kind, mesh) == ("prefill", (2, 8)) else FLOPS_TOL)


@pytest.mark.parametrize("cell", TRAIN, ids=[f"{a}-{k}-{d}x{m}"
                                             for a, k, (d, m) in TRAIN])
def test_train_and_mamba_flops_match_reference_hlo(op_counts, cell):
    ref, port = op_counts[cell]
    _flops_within(ref, port, PREFILL_2X8_TOL
                  if cell[1:] == ("train", (2, 8)) else FLOPS_TOL)


@pytest.mark.parametrize("mesh", [(2, 4), (2, 8)])
def test_decode_hbm_bytes_near_reference(op_counts, mesh):
    ref, port = op_counts[counts.LLAMA, "decode", mesh]
    assert port["hbm_bytes"] <= DECODE_HBM_MAX * ref["hbm_bytes"], \
        (port, ref)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    path = str(tmp / "oracle.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([ranks.SRC, HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    code = ORACLE % dict(cases=ALL, B=B, P=PROMPT, path=path)
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
        got = ranks.run("tp", world, tmp, npz=str(tmp / "oracle.npz"),
                        cases=cases)
        for name, *_ in cases:
            out[name] = got
    return out


def _close(got, want, tol, msg):
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("case", ALL, ids=[c[0] for c in ALL])
def test_prefill_matches_reference_sharded(oracle, runs, case):
    name = case[0]
    _, d = oracle
    for r, got in enumerate(runs[name]):
        _close(got[f"{name}/prefill/logits"], d[f"{name}/prefill/logits"],
               LOGITS_TOL, f"rank {r}")
        names = {k.split("/")[-1] for k in got
                 if k.startswith(f"{name}/prefill/cache/")}
        assert names == {k.split("/")[-1] for k in d
                         if k.startswith(f"{name}/cache/")}
        for n in names:
            _close(got[f"{name}/prefill/cache/{n}"], d[f"{name}/cache/{n}"],
                   CACHE_TOL, f"rank {r} {n}")


@pytest.mark.parametrize("case,pos", [(c, p) for c in ALL for p in c[5]],
                         ids=[f"{c[0]}-{p}" for c in ALL for p in c[5]])
def test_decode_matches_reference_sharded(oracle, runs, case, pos):
    name = case[0]
    _, d = oracle
    for r, got in enumerate(runs[name]):
        _close(got[f"{name}/{pos}/logits"], d[f"{name}/{pos}/logits"],
               LOGITS_TOL, f"rank {r}")
        for n in ("k", "v"):
            _close(got[f"{name}/{pos}/cache/{n}"],
                   d[f"{name}/{pos}/cache/{n}"], CACHE_TOL,
                   f"rank {r} {n}")


@pytest.mark.parametrize("leaf", sorted(HELD))
def test_decode_layer_holds_a_quarter_of_each_weight(runs, leaf):
    """On (1, 4) each rank's wq, wo, w1, w2, w3 and vocabulary tables are a
    quarter of the whole in every decode layer."""
    whole = int(np.prod(HELD[leaf]))
    for r, got in enumerate(runs["kv_apart"]):
        shape = tuple(got[f"kv_apart/held/{leaf}"].tolist())
        assert int(np.prod(shape)) * 4 == whole, (r, leaf, shape)
