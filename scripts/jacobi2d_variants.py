#!/usr/bin/env python3
"""Diagnostic variants of the port's Jacobi-2D cluster kernel, timed beside
the kernel itself on one CUDA card.

    python3 scripts/jacobi2d_variants.py   # from the root

At RiVec's 164 x 164 float32 grid (the app's 4,000 sweeps; seed 2111), on
one cluster of 16 CTAs, each build is timed (CUDA events, median of 5
launches) at 1 and at 8 sweeps between cluster barriers:

- ``kernel``: ``src/repro_torch/csrc/jacobi2d.cu`` as committed;
- text-substituted copies of the source (built with the kernel's own nvcc
  flags into ``build/variants/``; the script fails if a text to replace is
  not found once), each a part of the work taken away, so its results are
  wrong and only its time counts: ``no-sweeps`` (no point is updated:
  loads, stores and the arithmetic gone; the barriers, the halo copies and
  exchanges stay), ``no-cta-barrier`` (no CTA barrier between the sweeps
  of a block), ``no-exchange`` (no halo rows stored into the neighbours'
  inboxes, nor copied in from the own) and ``no-cluster-barrier`` (no
  exchange, and a CTA barrier in place of the cluster barrier that ends
  a block).

The committed kernel's result is held against 4,000 sweeps of the plain
version (the same bits).  Each build's ptxas lines for the float32
cluster kernel, and the card's name and power limit, are printed.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, SWEEPS, CTAS = 164, 4_000, 16
# the texts the variants replace, and what replaces them
NO_SWEEPS = ("      for (int c = 1 + threadIdx.x; c < C - 1; "
             "c += blockDim.x) {",
             "      for (int c = 1 + threadIdx.x; c < C - 1 && iters < 0; "
             "c += blockDim.x) {")
NO_CTA_BARRIER = ("      __syncthreads();\n      cur = span - cur;",
                  "      cur = span - cur;")
NO_EXCHANGE = ("    if (done > 0) {", "    if (done < 0) {")
NO_EXCHANGE_PUSH = ("    if (done < iters) {   // this block's edge rows to "
                    "the neighbours", "    if (done < iters && iters < 0) {")
NO_EXCHANGE_SYNC = ("      cluster.sync();\n    }\n  }\n",
                    "    }\n    if (done < iters) cluster.sync();\n  }\n")
# on top of no-exchange (a CTA must not leave while another still stores
# into it, so the variant without the barrier has no exchange either)
NO_CLUSTER_BARRIER = ("    if (done < iters) cluster.sync();",
                      "    if (done < iters) __syncthreads();")


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the text to replace is not in the source once:"
                         f"\n{old}")
    return text.replace(old, new)


def build(build_mod, variants: dict) -> dict:
    """One nvcc per variant, all at once."""
    procs = {}
    for name, src in variants.items():
        d = ROOT / "build" / "variants" / f"jacobi2d-{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "jacobi2d.cu").write_text(src)
        flags = [f for f in build_mod.flags("jacobi2d")
                 if f not in ("-I", str(build_mod.CSRC))]
        cmd = [build_mod.nvcc(), *flags, "-o", str(d / "libjacobi2d.so"),
               str(d / "jacobi2d.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       d / "libjacobi2d.so")
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        lines, entry = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = "cluster_kernelIf" in ln
            elif entry and ("spill" in ln or "Used" in ln):
                lines.append(ln.strip())
        print(f"{name} ptxas (float32 cluster kernel): " + " | ".join(lines))
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jacobi2d_cluster_launch.argtypes = [p, p, i, i, i, i, i, i, p]
        lib.jacobi2d_cluster_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def events_ms(torch, fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        code = fn()
        end.record()
        end.synchronize()
        if code:
            raise SystemExit(f"launch failed: CUDA error {code}")
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("jacobi2d_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.kernels import ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build.CSRC / "jacobi2d.cu").read_text()
    no_exchange = substitute(substitute(substitute(src, *NO_EXCHANGE),
                                        *NO_EXCHANGE_PUSH), *NO_EXCHANGE_SYNC)
    libs = build(_build, {
        "kernel": src,
        "no-sweeps": substitute(src, *NO_SWEEPS),
        "no-cta-barrier": substitute(src, *NO_CTA_BARRIER),
        "no-exchange": no_exchange,
        "no-cluster-barrier": substitute(no_exchange, *NO_CLUSTER_BARRIER)})
    grid = np.random.default_rng(2111).uniform(size=(N, N)).astype(np.float32)
    a = torch.from_numpy(grid).cuda()
    out = torch.empty_like(a)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    run = lambda lib, k: lib.jacobi2d_cluster_launch(
        a.data_ptr(), out.data_ptr(), N, N, 0, SWEEPS, CTAS, k, stream())
    if run(libs["kernel"], 8):
        raise SystemExit("the kernel's launch failed")
    want = ref.jacobi2d(a, SWEEPS)
    if not torch.equal(out, want):
        raise SystemExit("the kernel differs from the plain version")
    times = {}
    for name, lib in list(libs.items()) + list(libs.items())[::-1]:
        for k in (1, 8):
            times.setdefault((name, k), []).append(
                events_ms(torch, lambda: run(lib, k)))
    print(f"{N} x {N} float32, {SWEEPS} sweeps, {CTAS} CTAs (ms, two rounds "
          "in turns; the kernel equal to the plain version):")
    for (name, k), ms in times.items():
        print(f"  {name}, {k} sweep(s) between cluster barriers: "
              + " / ".join(f"{t:.4f}" for t in ms)
              + f" ({statistics.mean(ms) * 1e3 / SWEEPS:.4f} us a sweep)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
