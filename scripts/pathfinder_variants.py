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
- the plan for this card (``pathfinder.card``) and for a card of 114
  SMs (an H100 PCIe's count) on Rodinia's wall;
- the pyramid route (``pathfinder_pyramid_kernel``) on the wall's first
  21 rows (the main path's call), its first 41, the first 21 as float32
  and all 1,604 rows, back to back and in device time behind a spin,
  beside copies with 4 columns a lane (a ring of 16 rows), rings of 4 and
  16 rows, blocks of 4 warps, torch.minimum's compare-and-select in place
  of the hardware min over int32 walls (``tmin-int``), every window
  masked as the two at the wall's ends are (``mask-all``) and no wall
  loaded (``pyr-no-loads``), and beside Rodinia's own pyramid (256-column
  blocks, 20 rows a launch in shared memory, one ``__syncthreads`` a
  row: the route's kernel before this one, ``RODINIA``), all but
  ``pyr-no-loads`` held bit for bit;
- both routes on walls around the plan's crossover (2 to 200 rows at
  100,000, 10,000 and 1,000 columns), on Rodinia's rows at few columns,
  and past the widest strips, each back to back and in device time
  behind a spin;
- the wrappers' calls on the wall's first 21 rows and on all 1,604:
  ``pathfinder.pyramid`` beside the parent's wrapper on Rodinia's pyramid
  (``parent_pyramid``: a scratch row every call, the device's context and
  current stream taken in the call), in turns (parent, this tree, this
  tree, parent), each back to back, in device time behind a spin, in
  device time with L2 flushed before each call and in host issue time
  (``chip_smoke.call_times``), with the bound's share.

The ptxas lines and the SASS counts (LDL / STL, BAR, SHFL, ...) of the
strip kernels, the ptxas lines of the pyramid kernels, and the card's
name and power limit, are printed.
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
# the pyramid's windows, ring and block
PYR = "constexpr int PYR_K = 8, PYR_D = 8, PYR_WARPS = 1;"
PYR_VARIANTS = {
    "pyr-k4": (PYR, "constexpr int PYR_K = 4, PYR_D = 16, PYR_WARPS = 1;"),
    "pyr-d4": (PYR, "constexpr int PYR_K = 8, PYR_D = 4, PYR_WARPS = 1;"),
    "pyr-d16": (PYR, "constexpr int PYR_K = 8, PYR_D = 16, PYR_WARPS = 1;"),
    "pyr-w4": (PYR, "constexpr int PYR_K = 8, PYR_D = 8, PYR_WARPS = 4;"),
    "tmin-int": ("  return fminf(a, b);", "  return tmin(a, b);"),
    "mask-all": ("  if (__any_sync(0xffffffffu, inside != (1u << K) - 1))",
                 "  if (inside | 1u)"),
    "pyr-no-loads": ("""      if (inside >> q & 1u)
        u = *""", """      if ((inside >> q & 1u) && x < -4000000000ll)
        u = *""")}
# Rodinia's own pyramid, the route's kernel before the warp windows: a
# block of 256 threads a 256-column strip, 20 rows a launch in shared
# memory with one __syncthreads a row, strips overlapping by 20 a side
RODINIA = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr float END = 3.0e38f;
constexpr int TILE = 256, PYRAMID = 20, STRIDE = TILE - 2 * PYRAMID;
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int32_t v) { return (float)v; }
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float step(float w, float v, float l, float r) {
  return w + tmin(v, tmin(l, r));
}
template <typename W>
__global__ void __launch_bounds__(TILE)
pathfinder_kernel(const W* __restrict__ wall, const float* __restrict__ in,
                  float* __restrict__ out, long long row0, int nrows, int C) {
  __shared__ float buf[2][TILE];
  const int t = threadIdx.x;
  const long long col = (long long)blockIdx.x * STRIDE - PYRAMID + t;
  const bool live = col >= 0 && col < C;
  float w[PYRAMID];
#pragma unroll
  for (int i = 0; i < PYRAMID; ++i)
    w[i] = (live && i < nrows) ? to_f(wall[(row0 + i) * C + col]) : 0.0f;
  float v = END;
  if (live) v = in ? in[col] : to_f(wall[col]);
  buf[0][t] = v;
#pragma unroll
  for (int i = 0; i < PYRAMID; ++i) {
    if (i >= nrows) break;
    __syncthreads();
    const float* cur = buf[i & 1];
    const float left = t > 0 ? cur[t - 1] : END;
    const float right = t < TILE - 1 ? cur[t + 1] : END;
    v = live ? step(w[i], v, left, right) : END;
    buf[(i + 1) & 1][t] = v;
  }
  if (live && t >= PYRAMID && t < TILE - PYRAMID) out[col] = v;
}
template <typename W>
int launch(const W* wall, float* out, float* scratch, long long r, int c,
           cudaStream_t stream) {
  const long long n = r > 1 ? (r - 1 + PYRAMID - 1) / PYRAMID : 1;
  const unsigned blocks = (unsigned)((c + STRIDE - 1) / STRIDE);
  const float* in = nullptr;
  for (long long s = 0; s < n; ++s) {
    const long long row0 = 1 + s * PYRAMID;
    const long long left = r - row0;
    const int nrows = (int)(left < PYRAMID ? (left > 0 ? left : 0) : PYRAMID);
    float* dst = ((n - 1 - s) % 2 == 0) ? out : scratch;
    pathfinder_kernel<W><<<blocks, TILE, 0, stream>>>(wall, in, dst, row0,
                                                      nrows, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in = dst;
  }
  return 0;
}
}  // namespace
extern "C" int rodinia_pyramid_launch(const void* wall, int is_int,
                                      float* out, float* scratch,
                                      long long r, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int)
    return launch(static_cast<const int32_t*>(wall), out, scratch, r, c, s);
  return launch(static_cast<const float*>(wall), out, scratch, r, c, s);
}
"""


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
        lines, entry = [], None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = next((e for e in ("strips_kernelIi",
                                          "pyramid_kernelIi",
                                          "pathfinder_kernelIi") if e in ln),
                             None)
            elif entry and ("spill" in ln or "Used" in ln):
                lines.append(f"{entry}: {ln.strip()}")
        print(f"{name} ptxas (int32 kernels): " + " | ".join(lines))
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "rodinia":
            lib.rodinia_pyramid_launch.argtypes = [p, i, p, p, ll, i, p]
            lib.rodinia_pyramid_launch.restype = ctypes.c_int
        else:
            lib.pathfinder_strips_launch.argtypes = [p, i, p, p, ll, i, i, i,
                                                     i, i, i, p]
            lib.pathfinder_strips_launch.restype = ctypes.c_int
            lib.pathfinder_pyramid_launch.argtypes = [p, i, p, p, ll, i, i,
                                                      i, i, ll, i, p]
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


def parent_pyramid(torch, path_mod, lib, wall):
    """The pyramid wrapper before the warp windows, on ``RODINIA``'s
    kernel: the same checks, a scratch row every call, and the device's
    context and current stream taken in the call."""
    wall = path_mod._checked(wall, cuda=True)
    R, C = wall.shape
    out = torch.empty(C, dtype=torch.float32, device=wall.device)
    scratch = torch.empty_like(out)
    with torch.cuda.device(wall.device):
        code = lib.rodinia_pyramid_launch(
            wall.data_ptr(), int(wall.dtype == torch.int32), out.data_ptr(),
            scratch.data_ptr(), R, C, torch.cuda.current_stream().cuda_stream)
    if code:
        raise SystemExit(f"rodinia: CUDA error {code}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pathfinder_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
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
        **{name: substitute(src, *sub) for name, sub in PYR_VARIANTS.items()},
        "rodinia": RODINIA})
    strip_builds = ("kernel", "loads-only", "no-waits", "no-loads", "nan-min")
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
    for name in strip_builds + strip_builds[::-1]:
        times.setdefault(name, []).append(
            events_ms(torch, lambda lib=libs[name][0]: strips(lib)))
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
    pyramid_builds = ("kernel", *PYR_VARIANTS, "rodinia")
    print("the pyramid route (ms a call back to back [device time behind a "
          "spin]; * differs from the plain version, as it must):")
    for rows, dtype in ((21, torch.int32), (41, torch.int32),
                        (21, torch.float32), (R, torch.int32)):
        w = wall[:rows].to(dtype)
        want_w = ref.pathfinder(w)
        plan = path_mod.pyramid_plan(rows, C)
        cells = []
        for name in pyramid_builds:
            lib = libs[name][0]
            # the build's own window (pyr-k4: 4 columns a lane), which its
            # launch checks
            p = path_mod.pyramid_plan(rows, C, 128 if name == "pyr-k4"
                                      else 256)
            if name == "rodinia":
                run = lambda lib=lib: lib.rodinia_pyramid_launch(
                    w.data_ptr(), int(dtype == torch.int32), out.data_ptr(),
                    scratch.data_ptr(), rows, C, stream())
            else:
                run = lambda lib=lib, p=p: lib.pathfinder_pyramid_launch(
                    w.data_ptr(), int(dtype == torch.int32), out.data_ptr(),
                    scratch.data_ptr(), rows, C, p.h, p.ghost, p.middle,
                    p.windows, p.launches, stream())
            if run():
                raise SystemExit(f"pyramid {name}: the launch failed")
            torch.cuda.synchronize()
            same = torch.equal(out, want_w)
            if not same and name != "pyr-no-loads":
                raise SystemExit(f"pyramid {name}: differs from the plain "
                                 "version")
            cells.append(f"{name} {events_ms(torch, run):.4f} "
                         f"[{spun_ms(torch, run):.4f}]{'' if same else '*'}")
        print(f"  {rows:,} x {C:,} {str(dtype)[6:]} ({plan.launches} "
              f"launch(es) of {plan.h} rows; Rodinia's "
              f"{max(1, -(-(rows - 1) // 20))}): " + ", ".join(cells))
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
    walls += [(1_604, 64), (1_604, 1_000), (1_604, 10_000), (41, 405_504),
              (61, 200_000), (81, 405_504), (100, 405_504), (100, 506_880),
              (100, 1_000_003)]
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
    sm_clock_hz = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    print("the wrappers' calls (ms a call: back to back [device behind a "
          "spin] {device, L2 flushed before each call}; host issue; in "
          "turns: parent, pyramid, pyramid, parent):")
    for rows in (21, R):
        w = wall[:rows]
        want_w = ref.pathfinder(w)
        calls = {"parent": lambda w=w: parent_pyramid(
                     torch, path_mod, libs["rodinia"][0], w),
                 "pyramid": lambda w=w: path_mod.pyramid(w)}
        for name, fn in calls.items():
            if not torch.equal(fn(), want_w):
                raise SystemExit(f"{name} at {rows} rows differs from the "
                                 "plain version")
        times = {name: [] for name in calls}
        for name in ("parent", "pyramid", "pyramid", "parent"):
            times[name].append(cs.call_times(torch, calls[name],
                                             sm_clock_hz))
        bound = (rows * C * 4 + C * 4) / cs.PEAK_BYTES_S * 1e3
        for name, ts in times.items():
            print(f"  {rows:,} x {C:,} {name} (bound {bound:.4f} ms): "
                  + " / ".join(cs.call_times_text(t, bound) for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
