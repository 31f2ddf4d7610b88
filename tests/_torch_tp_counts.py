"""Per-device FLOPs, HBM bytes and collective bytes of the mesh's steps,
the port's op counter against the reference's HLO (CPU).

The cells (``CELLS``), each at ``InputShape("tiny", 64, 8, kind)``:
llama3-8b ``.smoke()``'s prefill and decode on the meshes (data 2, model
4) and (2, 8) and its train step on both, mamba2-130m ``.smoke()``'s
train and decode steps on (2, 4).  Each side
runs in its own process: the reference compiles each step
(``repro.launch.dryrun._builder``, in and out shardings, donation) on 16
fake host devices and counts its HLO (``hlo_analysis.analyze``); the port
runs each step once on meta tensors as rank 0 of a fake process group of
16 (``repro_torch.launch.dryrun._builder``) under ``op_analysis.OpCounter``.

    python tests/_torch_tp_counts.py [--src DIR]

prints a row a cell, the port's counts over the reference's; ``--src``
counts the port in another checkout's ``src`` (a parent commit, say).
``tests/test_torch_tensor_parallel.py`` holds the FLOPs to the reference's.
The counter runs a train step once with a single microbatch.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
SEQ, BATCH = 64, 8
LLAMA, MAMBA = "llama3-8b", "mamba2-130m"
# (arch, kind, (data, model))
CELLS = ((LLAMA, "decode", (2, 4)), (LLAMA, "decode", (2, 8)),
         (LLAMA, "prefill", (2, 4)), (LLAMA, "prefill", (2, 8)),
         (LLAMA, "train", (2, 4)), (LLAMA, "train", (2, 8)),
         (MAMBA, "train", (2, 4)), (MAMBA, "decode", (2, 4)))
WORLD = 16
KEYS = ("flops", "hbm_bytes", "ici_bytes")

REFERENCE = """
import json, jax
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import hlo_analysis
from repro.launch.dryrun import _builder
from repro.launch.mesh import make_host_mesh
from repro.models import api as mapi
out = []
for arch, kind, (data, m) in %(cells)r:
    model = mapi.build(get_config(arch).smoke())
    mesh = make_host_mesh(data=data, model=m)
    fn, in_sh, out_sh, donate, args = _builder(
        model, InputShape("tiny", %(seq)r, %(batch)r, kind), mesh, micro=1)
    co = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                 donate_argnums=donate).lower(*args).compile()
    out.append(hlo_analysis.analyze(co.as_text()))
print(json.dumps(out))
"""

PORT = """
import json
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import op_analysis
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api as mapi
dryrun.init_fake(%(world)r)
out = []
for arch, kind, (data, m) in %(cells)r:
    model = mapi.build(get_config(arch).smoke())
    mesh = make_host_mesh(data=data, model=m)
    fn, args, _ = dryrun._builder(
        model, InputShape("tiny", %(seq)r, %(batch)r, kind), mesh, micro=1)
    counter = op_analysis.OpCounter()
    with counter:
        fn(*args)
    out.append(op_analysis.analyze(counter))
print(json.dumps(out))
"""


def _json_of(code: str, src: str, env: dict):
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **env)
    code = code % dict(cells=CELLS, seq=SEQ, batch=BATCH, world=WORLD)
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def reference_counts() -> list:
    """The reference's per-device counts of each cell, in ``CELLS``'
    order."""
    return _json_of(REFERENCE, SRC, {
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
        "JAX_PLATFORMS": "cpu"})


def port_counts(src: str = SRC) -> list:
    """The port's per-device counts of each cell (the port in ``src``)."""
    return _json_of(PORT, src, {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=SRC,
                    help="the src directory of the port to count")
    args = ap.parse_args(argv)
    ref, port = reference_counts(), port_counts(os.path.abspath(args.src))
    print("| arch, cell, mesh (data, model) | reference FLOPs / HBM B / "
          "collective B | port | port / reference |")
    print("|---|---|---|---|")
    for (arch, kind, mesh), r, p in zip(CELLS, ref, port):
        print(f"| {arch}, {kind}, {mesh} | " + " / ".join(
            f"{r[k]:,.0f}" for k in KEYS) + " | " + " / ".join(
            f"{p[k]:,.0f}" for k in KEYS) + " | " + " / ".join(
            f"{p[k] / r[k]:.3f}x" for k in KEYS) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
