"""The port's training loop against the reference's, and its entry points
(CPU).

A step-0 checkpoint of the reference's initial parameters and optimizer
state (``repro.train.checkpoint.save``) is resumed by both loops for four
steps on the same data (``batch_at`` is equal bit for bit): their losses
agree within 1e-5 of the reference's (relative; the step's float32 sums
in other orders, ~1e-7 a step on these configs).  Then the launcher
(``python -m repro_torch.launch.train --smoke``) and the two examples
(``train_lm``, ``quickstart``) run with ``--device cpu`` and few steps.
"""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.configs.base import InputShape as RefInputShape
from repro.models import build as ref_build
from repro.train import checkpoint as ref_ckpt
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop

LOSS_RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_both_loops_resume_the_references_checkpoint_alike(tmp_path, arch):
    rm = ref_build(ref_config(arch).smoke())
    rp = rm.init(jax.random.key(0))
    start = str(tmp_path / "start")
    ref_ckpt.save(start, 0, rp, ref_opt.init(rp))
    for d in ("ref", "port"):
        shutil.copytree(start, tmp_path / d)
    ref_state = ref_loop.train(
        rm, RefInputShape("t", 16, 4, "train"), None,
        loop_cfg=ref_loop.LoopConfig(total_steps=4, ckpt_every=2,
                                     ckpt_dir=str(tmp_path / "ref"),
                                     log_every=100), data_seed=3)
    state = loop.train(
        build(get_config(arch).smoke()), InputShape("t", 16, 4, "train"),
        None, loop_cfg=loop.LoopConfig(total_steps=4, ckpt_every=2,
                                       ckpt_dir=str(tmp_path / "port"),
                                       log_every=100),
        data_seed=3, device="cpu")
    assert state.step == ref_state.step == 4
    assert state.restarts == ref_state.restarts == 1
    np.testing.assert_allclose(state.losses, ref_state.losses,
                               rtol=LOSS_RTOL)
    assert ckpt.latest_step(str(tmp_path / "port")) == 4
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))


def test_loop_resume_continues_the_uninterrupted_run(tmp_path):
    """Stopping at step 2 and resuming to 4 gives the uninterrupted run's
    losses bit for bit on the CPU (the state round-trips exactly)."""
    model = build(get_config("qwen2.5-3b").smoke())
    shape = InputShape("t", 16, 4, "train")
    cfg = lambda d, n: loop.LoopConfig(total_steps=n, ckpt_every=2,
                                       ckpt_dir=str(tmp_path / d),
                                       log_every=100)
    # (the rate is in its warmup for all 4 steps: equal whatever
    # total_steps the schedule is given)
    whole = loop.train(model, shape, None, None, cfg("a", 4), device="cpu")
    first = loop.train(model, shape, None, None, cfg("b", 2), device="cpu")
    second = loop.train(model, shape, None, None, cfg("b", 4),
                        device="cpu")
    assert first.losses + second.losses == whole.losses


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launcher_trains_the_smoke_config(tmp_path):
    out = _run("repro_torch.launch.train", "--arch", "qwen2.5-3b",
               "--smoke", "--steps", "4", "--device", "cpu", "--ckpt",
               str(tmp_path / "ck"))
    assert "done: 4 steps" in out and "on cpu" in out
    assert ckpt.latest_step(str(tmp_path / "ck")) == 4


def test_train_lm_learns(tmp_path, capsys):
    from repro_torch.examples import train_lm
    assert train_lm.main(["--steps", "8", "--device", "cpu", "--ckpt",
                          str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "lm-10m" in out and "final loss" in out


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-small"])
def test_quickstart_trains_then_serves(tmp_path, capsys, arch):
    from repro_torch.examples import quickstart
    assert quickstart.main(["--arch", arch, "--steps", "3", "--device",
                            "cpu", "--ckpt", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out.splitlines()
    prompts = [ln for ln in out if ln.startswith("prompt")]
    assert len(prompts) == 2
    assert all(len(ln.split("->")[1].split(",")) == 8 for ln in prompts)


def test_the_entry_points_default_to_the_card(tmp_path):
    """Without ``--device`` the launcher asks for the CUDA device and, on
    a host without one, raises instead of falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "qwen2.5-3b", "--smoke", "--steps",
                           "1", "--ckpt", str(tmp_path / "ck")])
