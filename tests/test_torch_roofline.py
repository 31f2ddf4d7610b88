"""The roofline tools against the reference's (CPU).

- ``active_params``, ``total_params`` and ``model_flops`` equal to the
  reference's for the ten configs and the four shapes; the three-term
  ``Roofline`` row equal to the reference's given the same counts and the
  same chip figures.
- The op counter (``core/op_analysis.py``) on the reference's mini dry run
  (``tests/test_distributed.py``: llama3-8b ``.smoke()``,
  ``InputShape("tiny", 32, 8, "train")``, mesh (2, 4)) against the
  reference's ``hlo_analysis.analyze`` of the same cell's compiled HLO:
  per-device FLOPs within 10 %.  The HBM and collective bytes are printed
  as ratios to the reference's, with no bar: eager PyTorch fuses nothing,
  and where GSPMD picks its own collectives (all-reduces) the port's train
  step issues the reference's layout's own (``distributed/sharding.py``:
  the "model" shards of the "tp" axes kept, the residual split over the
  sequence, an all-gather before a block's column-parallel products and a
  reduce-scatter after its row-parallel ones; held to the reference's
  sharded step in ``tests/test_torch_tensor_parallel_train.py``).  Each
  side runs in its own
  process: the reference with 8 fake host devices, the port as rank 0 of
  a fake process group of 8.
- ``python -m repro_torch.launch.dryrun`` on one small cell in a
  subprocess: a record with a positive roofline row, rendered by
  ``roofline_report`` and read by ``study.roofline_table``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as ref_config
from repro.core import roofline as ref_rl
from repro_torch import roofline_report, study
from repro_torch.configs import get_config
from repro_torch.core import roofline

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
FLOPS_TOL = 0.10


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_equal_reference(arch):
    cfg, ref = get_config(arch), ref_config(arch)
    assert roofline.active_params(cfg) == ref_rl.active_params(ref)
    assert roofline.total_params(cfg) == ref_rl.total_params(ref)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch, shape):
    assert roofline.model_flops(get_config(arch), SHAPES[shape]) == \
        ref_rl.model_flops(ref_config(arch), SHAPES[shape])


def test_roofline_row_equals_reference_on_h100_figures():
    c = roofline.H100
    ref_chip = ref_rl.Chip(name=c.name, peak_flops=c.peak_flops,
                           hbm_bw=c.hbm_bw, ici_bw=c.ici_bw,
                           hbm_bytes=c.hbm_bytes)
    for counts in ((1.2e14, 2.6e12, 1.0e10), (3e9, 9e11, 4e11),
                   (5e12, 1e9, 9e12)):
        got = roofline.Roofline(*counts, model_flops=2e16, chips=256).row()
        want = ref_rl.Roofline(*counts, model_flops=2e16, chips=256,
                               chip=ref_chip).row()
        assert got == want
    assert (c.peak_flops, c.hbm_bw, c.ici_bw, c.hbm_bytes) == \
        (989e12, 3.35e12, 450e9, 80e9)


REF_MINI = """
import json, jax
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.models import api as mapi
from repro.train import trainstep
from repro.core import hlo_analysis
from repro.launch.mesh import make_host_mesh
cfg = get_config("llama3-8b").smoke()
model = mapi.build(cfg)
shape = InputShape("tiny", 32, 8, "train")
mesh = make_host_mesh(data=2, model=4)
fn, in_sh, out_sh, donate = trainstep.build_train_step(model, shape, mesh)
args = (model.param_structs(), trainstep.opt_structs(model.param_structs()),
        mapi.input_specs(cfg, shape))
co = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
             donate_argnums=donate).lower(*args).compile()
print(json.dumps(hlo_analysis.analyze(co.as_text())))
"""

PORT_MINI = """
import json
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import op_analysis
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api as mapi
dryrun.init_fake(8)
model = mapi.build(get_config("llama3-8b").smoke())
mesh = make_host_mesh(data=2, model=4)
fn, args, _ = dryrun._builder(model, InputShape("tiny", 32, 8, "train"),
                              mesh)
counter = op_analysis.OpCounter()
with counter:
    fn(*args)
print(json.dumps(op_analysis.analyze(counter)))
"""


def _json_of(code: str, env: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **env)
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_op_counter_matches_reference_hlo_on_mini_dry_run():
    ref = _json_of(REF_MINI, {"XLA_FLAGS":
                              "--xla_force_host_platform_device_count=8",
                              "JAX_PLATFORMS": "cpu"})
    port = _json_of(PORT_MINI, {})
    ratios = {k: port[k] / ref[k] for k in ("flops", "hbm_bytes",
                                            "ici_bytes")}
    print(f"port / reference on the mini dry run: {ratios}; port "
          f"{port}; reference {ref}")
    assert abs(ratios["flops"] - 1) <= FLOPS_TOL, ratios
    assert port["hbm_bytes"] > 0 and port["ici_bytes"] > 0
    assert port["static_collective_count"] > 0


def test_dryrun_cell_renders(tmp_path):
    out = tmp_path / "dryrun_torch.jsonl"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "single",
         "--batch", "16", "--seq", "2048", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    rl, pd = rec["roofline"], rec["per_device"]
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert min(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"],
               rl["roofline_fraction"], pd["flops"]) > 0
    assert pd["fits_80GB"] and pd["static_collectives"] > 0
    rows = roofline_report.load(str(out))
    assert "| qwen2.5-3b | decode_b16_s2048 | 16x16 |" in \
        roofline_report.dryrun_table(rows)
    assert "| qwen2.5-3b | decode_b16_s2048 |" in \
        roofline_report.roofline_tbl(rows)
    (row,) = study.roofline_table(out)
    assert row[0] == "roofline_qwen2.5-3b_decode_b16_s2048" and \
        row[2].startswith(f"bound={rl['bound']}|")
