#!/usr/bin/env python3
"""Diagnostic variants of the port's pathfinder kernels, timed beside the
kernels themselves on one CUDA card.

    python3 scripts/pathfinder_variants.py          # from the root

At Rodinia's 1,604 x 100,000 int32 wall (``rand() % 10``, seed 2111), CUDA
events around back-to-back calls (median of 10 samples of 5 calls), each
build timed in turns (the builds' order, then the reverse):

- ``kernel``: ``src/repro_torch/csrc/pathfinder.cu`` as committed, on the
  plan's strip route (``pathfinder.route``);
- text-substituted copies of the source (built with the kernel's own nvcc
  flags into ``build/variants/``; the script fails if a text to replace is
  not found once), each a part of the work taken away, so its results are
  wrong and only its time counts: ``loads-only`` (the wall streamed in and
  the phases' exchanges, no row step), ``no-waits`` (no ghost column read
  from the neighbours' edges, so no wait on their tags), ``no-loads`` (no
  wall slab copied in: the row steps and the exchanges alone), and
  ``nan-min`` (the mins as one ``min.NaN`` instruction each, in place of
  torch.minimum's compare-and-select: its results equal the kernel's on
  this wall);
- the committed kernel under other rows a phase (h 8, 16, 32, 64) and
  CTA counts (132, 264) where the strips fit, each result held against
  the plain version bit for bit;
- the pyramid route at PYRAMID 20 (committed) and 64 (a copy), through the
  C entry point, beside its launches;
- the plan for this card (``pathfinder.card``) and for a card of 114
  SMs (an H100 PCIe's count) on Rodinia's wall;
- both routes on walls around the plan's crossover (2 to 100 rows at
  100,000, 10,000 and 1,000 columns), on Rodinia's rows at few columns,
  and past the widest strips, each back to back and in device time
  behind a spin.

The ptxas lines and the SASS counts (LDL / STL, BAR, SHFL, ...) of the
strip kernels, and the card's name and power limit, are printed.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
R, C = 1_604, 100_000
# the texts the variants replace, and what replaces them
NO_STEPS = ("      for (int i = 0; i < n_rows; ++i) {",
            "      for (int i = 0; i < n_rows && H < 0; ++i) {")
NO_LOADS = ("      mbar_expect_tx(bar, bytes * rows);\n"
            "      for (int r = 0; r < rows; ++r)",
            "      mbar_expect_tx(bar, 0);\n      for (int r = 0; r < 0; ++r)")
NAN_MIN = ("  return (a < b || a != a) ? a : b;",
           "  float r;\n  asm(\"min.NaN.f32 %0, %1, %2;\" : \"=f\"(r) : \"f\"(a), "
           "\"f\"(b));\n  return r;")
NO_EDGES = ("        if (j < H && g > 0)", "        if (j < H && g < 0)")
NO_EDGES_R = ("        else if (j >= H + S && j < E && g < G - 1)",
              "        else if (j >= H + S && j < E && g < 0)")
PYRAMID_64 = ("constexpr int PYRAMID = 20;", "constexpr int PYRAMID = 64;")


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the text to replace is not in the source once:"
                         f"\n{old}")
    return text.replace(old, new)


def build(build_mod, variants: dict) -> dict:
    """One nvcc per variant, all at once."""
    procs = {}
    for name, src in variants.items():
        d = ROOT / "build" / "variants" / f"pathfinder-{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "pathfinder.cu").write_text(src)
        flags = [f for f in build_mod.flags("pathfinder")
                 if f not in ("-I", str(build_mod.CSRC))]
        cmd = [build_mod.nvcc(), *flags, "-o", str(d / "libpathfinder.so"),
               str(d / "pathfinder.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       d / "libpathfinder.so")
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        lines, entry = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = "strips_kernelIiE" in ln
            elif entry and ("spill" in ln or "Used" in ln):
                lines.append(ln.strip())
        print(f"{name} ptxas (int32 strip kernel): " + " | ".join(lines))
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pathfinder_strips_launch.argtypes = [p, i, p, p, ll, i, i, i, i,
                                                 i, i, p]
        lib.pathfinder_strips_launch.restype = ctypes.c_int
        lib.pathfinder_pyramid_launch.argtypes = [p, i, p, p, ll, i, p]
        lib.pathfinder_pyramid_launch.restype = ctypes.c_int
        libs[name] = (lib, path)
    return libs


def sass_counts(build_mod, path) -> str:
    """LDL / STL, BAR, SHFL and I2F instructions of the strip kernels."""
    cuobjdump = Path(build_mod.nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return f"not counted: no {cuobjdump}"
    run = subprocess.run([str(cuobjdump), "-sass", str(path)],
                         capture_output=True, text=True)
    ops, inside = [], False
    for ln in run.stdout.splitlines():
        if "Function :" in ln:
            inside = "strips_kernel" in ln
        elif inside and ln.lstrip().startswith("/*") and len(ln.split()) > 1:
            ops.append(ln.split()[1].split(".")[0].lstrip("@!P0123456789T"))
    return ", ".join(f"{op} {ops.count(op)}" for op in
                     ("LDL", "STL", "BAR", "SHFL", "I2F", "LDGSTS", "LDS"))


def events_ms(torch, fn, reps: int = 10, per: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            code = fn()
            if code:
                raise SystemExit(f"launch failed: CUDA error {code}")
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per)
    return statistics.median(samples)


def spun_ms(torch, fn, reps: int = 10, per: int = 5) -> float:
    """Device time (ms) of one ``fn`` call: the stream first spins ~2 ms
    while the host enqueues the ``per`` calls, so the events see the
    device's work alone."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per)
    return statistics.median(samples)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pathfinder_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.kernels import pathfinder as path_mod
    from repro_torch.kernels import ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build.CSRC / "pathfinder.cu").read_text()
    libs = build(_build, {
        "kernel": src,
        "loads-only": substitute(src, *NO_STEPS),
        "no-waits": substitute(substitute(src, *NO_EDGES), *NO_EDGES_R),
        "no-loads": substitute(src, *NO_LOADS),
        "nan-min": substitute(src, *NAN_MIN),
        "pyramid-64": substitute(src, *PYRAMID_64)})
    print(f"kernel SASS (strip kernels): "
          f"{sass_counts(_build, libs['kernel'][1])}")
    wall = torch.from_numpy(np.random.default_rng(2111).integers(
        0, 10, (R, C), dtype=np.int32)).cuda()
    want = ref.pathfinder(wall)
    rt = path_mod.route(R, C)
    out = torch.empty(C, dtype=torch.float32, device="cuda")
    scratch = torch.empty_like(out)
    edges = torch.empty(4 * rt.ctas * rt.h, dtype=torch.int64, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    strips = lambda lib: lib.pathfinder_strips_launch(
        wall.data_ptr(), 1, out.data_ptr(), edges.data_ptr(), R, C, rt.strip,
        rt.h, rt.sr, rt.ctas, 1, stream())
    if strips(libs["kernel"][0]) or not torch.equal(out, want):
        raise SystemExit("the strip kernel differs from the plain version")
    print(f"{R} x {C} int32 (ms; the plan {rt}, equal to the plain "
          "version):")
    times = {}
    if strips(libs["nan-min"][0]) or not torch.equal(out, want):
        raise SystemExit("nan-min differs from the plain version")
    for name, (lib, _) in list(libs.items()) + list(libs.items())[::-1]:
        if name != "pyramid-64":
            times.setdefault(name, []).append(
                events_ms(torch, lambda lib=lib: strips(lib)))
    for name, ts in times.items():
        print(f"  {name}: " + " / ".join(f"{t:.4f}" for t in ts))
    for h in (8, 16, 32, 64):
        for ctas in (132, 264):
            s = path_mod.strips(C, h, ctas)
            if s is None or path_mod.strips_fit(s) < s.ctas:
                print(f"  h {h}, {ctas} CTAs: the strips do not fit")
                continue
            if not torch.equal(path_mod.strip_run(wall, s), want):
                raise SystemExit(f"h {h}, {ctas} CTAs: differs")
            t = events_ms(torch, lambda: (path_mod.strip_run(wall, s), 0)[1])
            print(f"  h {h}, {ctas} CTAs (strips of {s.strip}, "
                  f"{path_mod.strip_warps(s.strip, s.h)} warps, slabs of "
                  f"{s.sr} rows, "
                  f"{path_mod.strip_smem(s.strip, s.h, s.sr) / 1024:.0f} KB): "
                  f"{t:.4f}")
    for name, pyr in (("kernel", 20), ("pyramid-64", 64)):
        lib = libs[name][0]
        run = lambda lib=lib: lib.pathfinder_pyramid_launch(
            wall.data_ptr(), 1, out.data_ptr(), scratch.data_ptr(), R, C,
            stream())
        if run() or not torch.equal(out, want):
            raise SystemExit(f"pyramid {pyr}: differs from the plain version")
        print(f"  pyramid at PYRAMID {pyr} ({-(-(R - 1) // pyr)} launches): "
              f"{events_ms(torch, run):.4f}")
    sms, smem = path_mod.card("cuda")
    for n in (sms, 114):
        s = path_mod.route(R, C, n, smem)
        if not torch.equal(path_mod.strip_run(wall, s), want):
            raise SystemExit(f"the plan for {n} SMs differs")
        t = events_ms(torch, lambda: (path_mod.strip_run(wall, s), 0)[1])
        print(f"  the plan for a card of {n} SMs ({s}): {t:.4f}")
    print("both routes on walls around the plan's crossover and past the "
          "widest strips (ms a call back to back [device time behind a "
          "spin]: strips at the first h that fits, pyramid; * the plan's "
          "route):")
    gen = torch.Generator("cuda").manual_seed(5)
    walls = [(r, c) for c in (100_000, 10_000, 1_000)
             for r in (2, 21, 41, 42, 50, 61, 70, 81, 100, 150, 200)]
    walls += [(1_604, 64), (1_604, 1_000), (1_604, 10_000), (100, 405_504),
              (100, 506_880), (100, 1_000_003)]
    for r, c in walls:
        w = torch.randint(0, 10, (r, c), dtype=torch.int32, device="cuda",
                          generator=gen)
        plan = path_mod.route(r, c, sms, smem)
        got = path_mod.pathfinder(w)
        if not torch.equal(got, ref.pathfinder(w)):
            raise SystemExit(f"{r} x {c}: the route differs")
        s = next((s for h in path_mod.H_CHOICES
                  if (s := path_mod.strips(c, h, sms, smem)) is not None),
                 None)
        run_strips = lambda: (path_mod.strip_run(w, s), 0)[1]
        run_pyr = lambda: (path_mod.pyramid(w), 0)[1]
        mark = lambda name: "*" if plan.name == name else ""
        strips_txt = ("no strips fit" if s is None else
                      f"strips (h {s.h}, {s.ctas} CTAs){mark('strips')} "
                      f"{events_ms(torch, run_strips):.4f} "
                      f"[{spun_ms(torch, run_strips):.4f}]")
        print(f"  {r} x {c}: {strips_txt}, pyramid{mark('pyramid')} "
              f"{events_ms(torch, run_pyr):.4f} "
              f"[{spun_ms(torch, run_pyr):.4f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
