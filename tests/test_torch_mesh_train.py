"""Checkpoints and the training loop on a mesh, and the launcher without
one (CPU, gloo ranks).

- A checkpoint of a sharded state saved on mesh (2, 1) restores on (1, 2)
  and on no mesh bit for bit (the reference's elastic claim), and its
  files are byte for byte those the reference's ``checkpoint.save`` writes
  for the same tree.  Rank 0 takes each shard into the slice its rank
  holds (``checkpoint._shard_slices`` against ``Sharding.local``, at every
  coordinate of a (2, 2, 2) mesh).
- The loop under a mesh (1, 2): stopped at step 2 and resumed to 4, its
  losses equal an uninterrupted run's, and within 1e-5 (relative) of the
  loop's on one device (the step's sums in other orders).
- ``python -m repro_torch.launch.train --smoke`` runs with no mesh: its
  final loss is the one-device loop's.
- Every family's prefill, decode steps (caches of every kind: K/V over
  the sequence, the SSM states and the cross-attention K/V re-laid for
  the step and written back) and train step on a mesh (1, 2) against the
  same steps on one device, within 1e-5 (float32 sums in other orders).
  The MoE families' train step within 1e-3: their load-balance loss on a
  mesh is the mean of each shard's (the reference's ``pmean``), not the
  whole batch's, which moves the loss by ~1e-4 (aux weight 0.01).
"""
import filecmp
import itertools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro.configs import get_config as ref_config
from repro.models import build as ref_build
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep

ARCH = "qwen2.5-3b"
LOSS_RTOL = 1e-5
FAMILY_ARCHS = ("qwen2.5-3b", "granite-moe-3b-a800m", "mamba2-130m",
                "jamba-v0.1-52b", "whisper-small", "internvl2-76b")
FAMILY_TOL = 1e-5
MOE_TRAIN_TOL = 1e-3


@pytest.fixture(scope="module")
def state_npz(tmp_path_factory):
    """The reference's initial parameters and a seeded optimizer state
    (moments drawn from numpy, step 3), as arrays and as an ``.npz``."""
    tmp = tmp_path_factory.mktemp("ckpt")
    params = jax.tree.map(np.asarray, ref_build(
        ref_config(ARCH).smoke()).init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    draw = lambda a: rng.normal(size=a.shape).astype(np.float32)
    mu, nu = jax.tree.map(draw, params), jax.tree.map(draw, params)
    flat = {**{f"params/{k}": v for k, v in ranks.flat(params).items()},
            **{f"mu/{k}": v for k, v in ranks.flat(mu).items()},
            **{f"nu/{k}": v for k, v in ranks.flat(nu).items()},
            "step": np.int32(3)}
    np.savez(tmp / "state.npz", **flat)
    return tmp, params, mu, nu


@pytest.fixture(scope="module")
def crossed(state_npz):
    tmp, *_ = state_npz
    return ranks.run("ckpt", 2, tmp, npz=str(tmp / "state.npz"), arch=ARCH,
                     save_mesh=(2, 1), restore_mesh=(1, 2),
                     ckpt_dir=str(tmp / "sharded"))


def test_checkpoint_crosses_meshes_bitwise(state_npz, crossed):
    _, params, mu, _ = state_npz
    want = {**{f"params/{k}": v for k, v in ranks.flat(params).items()},
            **{f"mu/{k}": v for k, v in ranks.flat(mu).items()}}
    for r, got in enumerate(crossed):
        assert int(got["step"]) == 3
        for name, a in want.items():
            assert np.array_equal(got[name].numpy(), a), (r, name)


def test_sharded_checkpoint_restores_without_mesh(state_npz, crossed):
    tmp, params, mu, nu = state_npz
    model = build(get_config(ARCH).smoke())
    structs = model.param_structs()
    p, s, manifest = ckpt.restore(str(tmp / "sharded"), 3, structs,
                                  trainstep.opt_structs(structs),
                                  device="cpu")
    assert manifest["step"] == 3 and manifest["extra"] == {"loss": 1.5}
    for tree, want in ((p, params), (s.mu, mu), (s.nu, nu)):
        got = ranks.flat(jax.tree.map(lambda t: t.numpy(), tree))
        for name, a in ranks.flat(want).items():
            assert np.array_equal(got[name], a), name


def test_sharded_save_writes_the_references_bytes(state_npz, crossed):
    tmp, params, mu, nu = state_npz
    ref_ckpt.save(str(tmp / "ref"), 3, params,
                  ref_opt.OptState(step=np.int32(3), mu=mu, nu=nu),
                  extra={"loss": 1.5})
    a, b = tmp / "ref" / "step_00000003", tmp / "sharded" / "step_00000003"
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b))
    with open(a / "manifest.json") as fa, open(b / "manifest.json") as fb:
        assert json.load(fa) == json.load(fb)
    _, mismatch, errors = filecmp.cmpfiles(
        a, b, [f for f in files if f.endswith(".npy")], shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _one_device_losses(tmp):
    st = loop.train(build(get_config(ARCH).smoke()),
                    InputShape("t", 16, 4, "train"), None,
                    opt_cfg=opt.OptConfig(total_steps=4),
                    loop_cfg=loop.LoopConfig(total_steps=4, ckpt_every=2,
                                             ckpt_dir=str(tmp),
                                             log_every=100),
                    data_seed=3, device="cpu")
    return st.losses


class _MeshAt:
    """The names and shape of a (2, 2, 2) mesh seen from one coordinate:
    what ``Sharding.local`` reads of a mesh."""
    axis_names = ("pod", "data", "model")
    axes, size = Mesh.axes, Mesh.size

    def __init__(self, coord):
        self.c = coord
        self.shape = dict(zip(self.axis_names, (2, 2, 2)))

    def coord(self, axes):
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.c[self.axis_names.index(a)]
        return i


@pytest.mark.parametrize("spec", [(("pod", "data"), "model"),
                                  ("model", None, "data"), (None, "pod"),
                                  ()])
def test_sharded_save_takes_each_shard_from_where_it_lies(spec):
    """The slices a sharded save copies each rank's shard into
    (``checkpoint._shard_slices``) are the slices ``Sharding.local`` cuts
    for that rank, at every coordinate of a (2, 2, 2) mesh."""
    full = torch.arange(8 * 4 * 6).reshape(8, 4, 6)
    for coord in itertools.product(range(2), repeat=3):
        sh = shd.Sharding(_MeshAt(coord), spec)
        got = full[ckpt._shard_slices(full.shape, sh.placements, (2, 2, 2),
                                      coord)]
        assert torch.equal(got, sh.local(full)), (spec, coord)


def test_loop_resumes_under_a_mesh(tmp_path):
    whole = ranks.run("loop", 2, tmp_path, arch=ARCH, mesh=(1, 2),
                      ckpt_dir=str(tmp_path / "whole"), stop=0)
    resumed = ranks.run("loop", 2, tmp_path, arch=ARCH, mesh=(1, 2),
                        ckpt_dir=str(tmp_path / "resumed"), stop=2)
    for w, r in zip(whole, resumed):
        assert int(r["restarts"]) == 1
        np.testing.assert_array_equal(r["losses"].numpy(),
                                      w["losses"].numpy())
    np.testing.assert_allclose(whole[0]["losses"].numpy(),
                               _one_device_losses(tmp_path / "one"),
                               rtol=LOSS_RTOL)


def test_launcher_smoke_runs_without_a_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=ranks.SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "4", "--device", "cpu", "--ckpt",
         str(tmp_path / "launch")], capture_output=True, text=True, env=env,
        timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    last = run.stdout.strip().splitlines()[-1]
    assert last.startswith("done: 4 steps"), last
    st = loop.train(build(get_config(ARCH).smoke()),
                    InputShape("smoke", 32, 8, "train"), None,
                    loop_cfg=loop.LoopConfig(total_steps=4, ckpt_every=1,
                                             ckpt_dir=str(tmp_path / "loop"),
                                             log_every=100),
                    device="cpu")
    assert f"final loss {st.losses[-1]:.4f}" in last, last


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return ranks.run("families", 2, tmp_path_factory.mktemp("families"),
                     archs=FAMILY_ARCHS, mesh=(1, 2))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_steps_alike_on_a_mesh(families, arch):
    moe = get_config(arch).num_experts > 0
    for r, got in enumerate(families):
        n = int(got[f"{arch}/n_serve"])
        items = sorted({int(k.split("/")[1]) for k in got
                        if k.startswith(arch + "/") and k.endswith("/mesh")})
        assert len(items) > n
        for i in items:
            tol = MOE_TRAIN_TOL if moe and i >= n else FAMILY_TOL
            np.testing.assert_allclose(
                got[f"{arch}/{i}/mesh"].numpy(),
                got[f"{arch}/{i}/one"].numpy(), rtol=tol, atol=tol,
                err_msg=f"rank {r} item {i}")
