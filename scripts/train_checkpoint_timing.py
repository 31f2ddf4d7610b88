#!/usr/bin/env python3
"""Time one checkpoint save and restore of qwen2.5-3b's full training
state on one CUDA card, then run ``examples.train_lm --full``.

    python3 scripts/train_checkpoint_timing.py [--dir DIR] [--no-train-lm]

The state is the port's: qwen2.5-3b's parameters drawn from seed 0 in
bfloat16 (3.40 B) and an AdamW state with float32 moments after one
optimizer step on zero-free gradients (so no file is all zeros), ~34 GB
of ``.npy`` files.  Prints the card's name and power limit, then
``shutil.disk_usage`` of the target and stops if it lacks room; times
``train.checkpoint.save`` (device to host, ``.npy`` writes, the atomic
rename) and ``restore`` onto the card (meta likes: no second copy of
the tree is drawn), checks the restored tree bit for bit against the
saved one, and removes the files.  The page cache is left as it is: the
restore reads files the save has just written (warm).  Then
``examples.train_lm --full`` (lm-100m, 300 steps) with its own timing
lines.  Without a card it exits 2.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None,
                    help="where the checkpoint goes (default: a temporary "
                         "directory)")
    ap.add_argument("--no-train-lm", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.stdout.reconfigure(line_buffering=True)
    import torch
    if not torch.cuda.is_available():
        print("train_checkpoint_timing: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda")
    model = build(get_config("qwen2.5-3b"))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)
    grads = L.tree_map(lambda p: torch.full_like(p, 1e-3), params)
    params, state, _ = opt.apply_(opt.OptConfig(), params, grads, state)
    del grads
    torch.cuda.synchronize()
    leaves = L.tree_leaves(params) + L.tree_leaves(state.mu) \
        + L.tree_leaves(state.nu)
    nbytes = sum(t.numel() * t.element_size() for t in leaves) + 4
    base = args.dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    os.makedirs(base, exist_ok=True)
    du = shutil.disk_usage(base)
    print(f"target {base}: disk_usage total {du.total / 1e9:.1f} GB, used "
          f"{du.used / 1e9:.1f} GB, free {du.free / 1e9:.1f} GB; the "
          f"checkpoint needs {nbytes / 1e9:.2f} GB")
    try:
        if du.free < 1.2 * nbytes:
            print("not enough room: save and restore not timed")
        else:
            t0 = time.perf_counter()
            ckpt.save(base, 1, params, state)
            save_s = time.perf_counter() - t0
            files = sorted(Path(base, "step_00000001").iterdir())
            on_disk = sum(f.stat().st_size for f in files)
            print(f"save: {save_s:.2f} s, {len(files)} files, "
                  f"{on_disk / 1e9:.2f} GB, {on_disk / save_s / 1e9:.2f} "
                  "GB/s")
            structs = model.param_structs()
            t0 = time.perf_counter()
            p2, s2, _ = ckpt.restore(base, 1, structs, opt.init(structs),
                                     device=dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            same = all(torch.equal(a, b) for a, b in zip(
                leaves, L.tree_leaves(p2) + L.tree_leaves(s2.mu)
                + L.tree_leaves(s2.nu))) and int(s2.step) == int(state.step)
            print(f"restore onto the card (warm page cache): {restore_s:.2f}"
                  f" s, {on_disk / restore_s / 1e9:.2f} GB/s; bit for bit "
                  f"{same}")
            if not same:
                return 1
            del p2, s2
    finally:
        shutil.rmtree(os.path.join(base, "step_00000001"),
                      ignore_errors=True)
        if args.dir is None:
            shutil.rmtree(base, ignore_errors=True)
    del params, state, leaves
    torch.cuda.empty_cache()
    if args.no_train_lm:
        return 0
    from repro_torch.examples import train_lm
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = train_lm.main(["--full", "--ckpt", tmp])
        print(f"train_lm --full: exit {rc}, "
              f"{time.perf_counter() - t0:.1f} s wall")
    return rc


if __name__ == "__main__":
    sys.exit(main())
