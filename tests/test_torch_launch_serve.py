"""The port's serving launcher and example as a user runs them, on the CPU
(``--device cpu``): each exits 0 having served every request; without
``--device`` on a host with no CUDA device the launcher exits nonzero with
``_device.resolve``'s message (no silent CPU run)."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_launcher_serves_on_the_cpu():
    r = _run("repro_torch.launch.serve", "--arch", "qwen2.5-3b", "--smoke",
             "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("8 requests, 64 tokens, "), r.stdout
    assert r.stdout.rstrip().endswith("tok/s on cpu")


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b"])
def test_launcher_feeds_the_stub_frontends(arch):
    """The encoder-decoder's frames and the VLM's patches: 2 requests of 3
    new tokens through 2 slots."""
    r = _run("repro_torch.launch.serve", "--arch", arch, "--smoke",
             "--device", "cpu", "--batch-size", "2", "--requests", "2",
             "--max-new-tokens", "3")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("2 requests, 6 tokens, "), r.stdout


def test_example_serves_on_the_cpu():
    r = _run("repro_torch.examples.serve_batched", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("served 9 requests, "), r.stdout
    assert len(lines) == 5 and all(ln.startswith("  req ") for ln in lines[1:])


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    r = _run("repro_torch.launch.serve", "--arch", "qwen2.5-3b", "--smoke")
    assert r.returncode != 0
    assert "runs on a CUDA device by default and none is available" in \
        r.stderr
