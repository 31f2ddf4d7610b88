#!/usr/bin/env python3
"""Diagnostic variants of the port's Jacobi-2D one-sweep, cluster and tiled
kernels, timed beside the kernels themselves on one CUDA card.

    python3 scripts/jacobi2d_variants.py                # from the root
    python3 scripts/jacobi2d_variants.py --only step    # the one-sweep kernel
    python3 scripts/jacobi2d_variants.py --only step --baseline OLD.cu
    python3 scripts/jacobi2d_variants.py --only tiled   # the tiled kernel
    python3 scripts/jacobi2d_variants.py --only cluster

The one-sweep kernel at PolyBench 4.2.1 EXTRALARGE's 2,800 x 2,800 grid
(seed 2111) in float32, bfloat16 and float16 on its vector route, and on
its width-one route at 2,799 x 2,801 and on a float32 view one element into
its buffer, each build timed in three rounds in turns (CUDA events around 25
back-to-back launches, median of 10), then once more a launch at a time
after 256 MB written over L2 (median of 10), and held bit for bit against
the plain version:

- ``kernel``: the committed source;
- text-substituted copies (``build/variants/``): other (rows a tile, rows
  loaded ahead, chunks a thread) on the vector route (``vec<r>-<a>-<g>``)
  and on the width-one route (``one<r>-<a>-<g32>-<g16>``), stores without the
  streaming hint (``plain-stores``) and loads that allocate in L1
  (``l1-loads``);
- ``ring``: ``scripts/jacobi2d_ring.cu``, the vector route's grids as a
  ring of rows in shared memory fed by 16-byte cp.async from one loading
  warp (the design the register ring was weighed against);
- ``baseline``: another ``jacobi2d.cu`` given by ``--baseline`` (an older
  tree's, whose ``jacobi2d_launch`` takes no width), for the kernel a
  change replaces;
- yardsticks that are not the same function: ``Tensor.copy_`` of the grid
  (the same bytes, no arithmetic) and ``torch.nn.functional.conv2d`` over
  the interior with the cross stencil (boundary left out, another order of
  sums; float32 with cuDNN's TF32 off).

Then one sweep of grids far smaller than the card (164², 512², 1,000²), a
launch's latency more than its bytes, for the kernel and the baseline, in
device time (25 launches queued behind a ~1 ms spin); and
PolyBench's 1,000 sweeps on the loop route (one launch a sweep), in
float32 and bfloat16, for the kernel and the baseline.

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

The tiled kernel (the route past the cluster), at PolyBench 4.2.1
EXTRALARGE's 2,800 x 2,800 grid, 1,000 sweeps (seed 2111), float32 and
bfloat16, CUDA events around one call (median of 3):

- the committed kernel under other ``k`` (sweeps a launch), tiles (the
  shared buffers' rows x columns) and CTA sizes, through
  ``jacobi2d.tiled``, each result held against the plan's bit for bit;
- copies of the source (``build/variants/``): ``tiled-no-sweeps`` (the
  loads and the tile's store, no sweep) and ``tiled-loads-only`` (the
  loads alone), at the plan's tile and k;
- the loop route (1,000 launches of the one-sweep kernel) beside them;
- the routes on the grids the plan's thresholds separate: just past the
  cluster, narrow ones, and one sweep (tiled at k 1 against one launch of
  the one-sweep kernel).
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
# the tiled kernel: no sweep; and no store of the tile either (whole
# chunks, or point by point)
TILED_NO_SWEEPS = ("      for (int c = clo + tx; c <= chi && ty < by; "
                   "c += bx) {",
                   "      for (int c = clo + tx; c <= chi && ty < by && "
                   "kb < 0; c += bx) {")
TILED_NO_STORE = ("        *reinterpret_cast<uint4*>(out + (long long)",
                  "        if (kb < 0) *reinterpret_cast<uint4*>(out + "
                  "(long long)")
TILED_NO_STORE1 = ("        out[(long long)(r0 + lr) * C + c0 + lc] =",
                   "        if (kb < 0) out[(long long)(r0 + lr) * C + c0 "
                   "+ lc] =")
BIG, BIG_SWEEPS = 2_800, 1_000


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the text to replace is not in the source once:"
                         f"\n{old}")
    return text.replace(old, new)


def substitute_all(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the text to replace is not in the source:\n{old}")
    return text.replace(old, new)


def build(build_mod, variants: dict, entry=("cluster_kernelIf",),
          what: str = "float32 cluster kernel") -> dict:
    """One nvcc per variant, all at once; each build's ptxas lines for the
    kernels whose mangled names hold one of ``entry``."""
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
        lines, on = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                on = any(e in ln for e in entry)
            elif on and ("spill" in ln or "Used" in ln):
                lines.append(ln.strip())
        print(f"{name} ptxas ({what}): " + " | ".join(lines))
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        # the one-sweep entries: with the width argument, or (an older
        # source's) without it; a design of one kernel has only its own
        width = "int width" in (path.parent / "jacobi2d.cu").read_text()
        entries = {
            "jacobi2d_launch": [p, p, i, i, i] + [i] * width + [p],
            "jacobi2d_loop_launch": [p, p, p, i, i, i] + [i] * width
            + [i, p],
            "jacobi2d_cluster_launch": [p, p, i, i, i, i, i, i, p],
            "jacobi2d_tiled_launch": [p, p, p, i, i, i, i, i, i, i, i, p]}
        for entry_name, argtypes in entries.items():
            if hasattr(lib, entry_name):
                fn = getattr(lib, entry_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.width = width
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


def tiled_variants(torch, build_mod, j2_mod, ref) -> None:
    """The tiled kernel at PolyBench's grid under other k and tiles, its
    loads and stores alone, the loop beside it, and the routes on the
    grids the plan's thresholds separate."""
    src = (build_mod.CSRC / "jacobi2d.cu").read_text()
    no_sweeps = substitute(src, *TILED_NO_SWEEPS)
    libs = build(build_mod, {"tiled-no-sweeps": no_sweeps,
                             "tiled-loads-only": substitute(substitute(
                                 no_sweeps, *TILED_NO_STORE),
                                 *TILED_NO_STORE1)})
    gen = np.random.default_rng(2111)
    grid32 = torch.from_numpy(gen.uniform(size=(BIG, BIG)).astype(
        np.float32)).cuda()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for g in (grid32, grid32.bfloat16()):
        dtype = g.dtype
        rt = j2_mod.route(BIG, BIG, dtype, iters=BIG_SWEEPS)
        want = j2_mod.tiled(g, BIG_SWEEPS, rt.k, rt.tile)
        if not torch.equal(want, ref.jacobi2d(g, BIG_SWEEPS)):
            raise SystemExit(f"tiled {dtype}: differs from the plain version")
        out, tmp = torch.empty_like(g), torch.empty_like(g)
        code = j2_mod.DTYPES[dtype]
        print(f"{BIG} x {BIG} {dtype}, {BIG_SWEEPS} sweeps (ms; the plan: "
              f"k {rt.k}, tile {rt.tile}, equal to the plain version):")
        t_loop = events_ms(torch, lambda: (j2_mod.loop(g, BIG_SWEEPS), 0)[1],
                           reps=3)
        print(f"  loop route (one launch a sweep): {t_loop:.4f}")
        rows, cols = j2_mod.TILED_BUFS[dtype.itemsize][0]
        plans = [(k, (rows - 2 * k, cols - 2 * k), 512)
                 for k in (1, 2, 4, 6, 8, 12, 16)]
        half = cols // 2   # rows of 256 bytes
        plans += [(8, (rows - 16, cols - 16), 256),
                  (8, (56 - 16, cols - 16), 256),
                  (8, (2 * rows - 16, cols - 16), 512),   # one CTA an SM
                  (8, (rows - 16, half - 16), 512),
                  (8, (2 * rows - 16, half - 16), 512)]
        for k, tile, threads in plans:
            if j2_mod.tiled_bytes(tile, k, dtype.itemsize) > j2_mod.MAX_SMEM:
                continue
            got = j2_mod.tiled(g, BIG_SWEEPS, k, tile, threads=threads)
            if not torch.equal(got, want):
                raise SystemExit(f"tiled k {k} tile {tile}: differs")
            t = events_ms(torch, lambda: (j2_mod.tiled(
                g, BIG_SWEEPS, k, tile, threads=threads), 0)[1], reps=3)
            kb = j2_mod.tiled_bytes(tile, k, dtype.itemsize) / 1024
            print(f"  tiled k {k}, tile {tile[0]} x {tile[1]} ({kb:.0f} KB a "
                  f"CTA, {threads} threads): {t:.4f} "
                  f"({t * 1e3 / BIG_SWEEPS:.4f} us a sweep, "
                  f"{-(-BIG_SWEEPS // k)} launches)")
        for name, lib in libs.items():
            run = lambda: lib.jacobi2d_tiled_launch(
                g.data_ptr(), out.data_ptr(), tmp.data_ptr(), BIG, BIG, code,
                BIG_SWEEPS, *rt.tile, rt.k, j2_mod.TILED_THREADS, stream())
            print(f"  {name} (k {rt.k}, the plan's tile): "
                  f"{events_ms(torch, run, reps=3):.4f}")
    # the plan's thresholds: the routes a sweep on grids past the cluster
    print("the routes a sweep (us), 64 sweeps unless said:")
    for (R, C), dtype in (((619, 619), torch.float32),
                          ((721, 721), torch.bfloat16),
                          ((1_000, 1_000), torch.float32),
                          ((16, 5_812), torch.float32),
                          ((17, 3_000), torch.float32),
                          ((3_000, 17), torch.float32),
                          ((100_000, 16), torch.float32),
                          ((100_000, 8), torch.float32),
                          ((2_097_123, 3), torch.float32)):
        g = torch.rand(R, C, device="cuda").to(dtype)
        rt = j2_mod.tiled_route(R, C, dtype, 64)
        t_tiled = events_ms(torch, lambda: (
            j2_mod.tiled(g, 64, rt.k, rt.tile), 0)[1], reps=3) * 1e3 / 64
        t_loop = events_ms(torch, lambda: (j2_mod.loop(g, 64), 0)[1],
                           reps=3) * 1e3 / 64
        if not torch.equal(j2_mod.tiled(g, 64, rt.k, rt.tile),
                           j2_mod.loop(g, 64)):
            raise SystemExit(f"{R} x {C}: the routes differ")
        print(f"  {R} x {C} {dtype} (the plan: "
              f"{j2_mod.route(R, C, dtype, iters=64).name}): tiled "
              f"{t_tiled:.4f}, loop {t_loop:.4f}")
    g = grid32
    one = j2_mod.tiled_route(BIG, BIG, torch.float32, 1)
    t1 = events_ms(torch, lambda: (j2_mod.tiled(g, 1, one.k, one.tile),
                                   0)[1])
    t_step = events_ms(torch, lambda: (j2_mod.loop(g, 1), 0)[1])
    print(f"  one sweep of {BIG} x {BIG} float32: tiled (k 1, tile "
          f"{one.tile}) {t1 * 1e3:.4f}, one-sweep kernel {t_step * 1e3:.4f}")


# the one-sweep kernel's knobs on each route: (rows a tile, rows loaded
# ahead, chunks a thread), at width one the chunks of a float32 and of a
# 16-bit grid; the committed values, and the copies timed
VEC_LINE = "constexpr int VEC_RUN = {}, VEC_AHEAD = {}, VEC_CHUNKS = {};"
ONE_LINE = ("constexpr int ONE_RUN = {}, ONE_AHEAD = {}, ONE_CHUNKS_32 = {}, "
            "ONE_CHUNKS_16 = {};")
VEC_KNOBS, ONE_KNOBS = (16, 3, 2), (16, 3, 4, 2)
VEC_TRIED = ((16, 3, 1), (8, 3, 2), (16, 2, 2))
ONE_TRIED = ((16, 1, 4, 2), (16, 3, 4, 1), (16, 3, 2, 2))


def step_variants(torch, build_mod, j2_mod, ref, baseline) -> None:
    """The one-sweep kernel beside its tuning copies, the baseline and the
    yardsticks, on both routes; then the loop route's 1,000 sweeps."""
    src = (build_mod.CSRC / "jacobi2d.cu").read_text()
    sources = {"kernel": src}
    for line, knobs, tried, tag in ((VEC_LINE, VEC_KNOBS, VEC_TRIED, "vec"),
                                    (ONE_LINE, ONE_KNOBS, ONE_TRIED, "one")):
        for k in tried:
            sources[tag + "-".join(map(str, k))] = substitute(
                src, line.format(*knobs), line.format(*k))
    sources["plain-stores"] = substitute_all(src, "st.global.cs.",
                                             "st.global.")
    sources["l1-loads"] = substitute_all(
        src, "ld.global.nc.L1::no_allocate.", "ld.global.nc.")
    sources["ring"] = (ROOT / "scripts" / "jacobi2d_ring.cu").read_text()
    if baseline:
        sources["baseline"] = Path(baseline).read_text()
    libs = build(build_mod, sources, entry=("jacobi2d_kernel", "ring_kernel"),
                 what="one-sweep kernel")
    gen = np.random.default_rng(2111)
    big = torch.from_numpy(gen.uniform(size=(BIG, BIG)).astype(
        np.float32)).cuda()
    odd = torch.from_numpy(gen.uniform(size=(BIG - 1, BIG + 1)).astype(
        np.float32)).cuda()
    flat = torch.from_numpy(gen.uniform(size=BIG * BIG + 1).astype(
        np.float32)).cuda()
    grids = {"float32": big, "bfloat16": big.bfloat16(),
             "float16": big.half(),
             "float32 2799 x 2801": odd, "bfloat16 2799 x 2801": odd.bfloat16(),
             "float16 2799 x 2801": odd.half(),
             "float32 view + 1": flat[1:].view(BIG, BIG)}
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def sweep(lib, g, out):
        width = j2_mod.step_width(g.shape[1], g.dtype, g.data_ptr(),
                                  out.data_ptr())
        return lib.jacobi2d_launch(g.data_ptr(), out.data_ptr(), *g.shape,
                                   j2_mod.DTYPES[g.dtype],
                                   *([width] if lib.width else []), stream())

    def per_launch(fn, per=25, reps=10):
        return events_ms(torch, lambda: max(fn() for _ in range(per)),
                         reps=reps) / per

    scrub = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def cold(fn, reps=10):
        """One launch after 256 MB written over L2 (the grid read from
        device memory), median of ``reps``."""
        samples = []
        for _ in range(reps):
            scrub.fill_(1)
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

    print("one sweep (ms a launch, three rounds in turns; every build "
          "equal to the plain version):")
    for label, g in grids.items():
        want = ref.jacobi2d(g)
        out = torch.empty_like(g)
        width = j2_mod.step_width(g.shape[1], g.dtype, g.data_ptr(),
                                  out.data_ptr())
        times = {}
        # the ring takes the vector route's grids only
        order = [(n, lib) for n, lib in libs.items()
                 if n != "ring" or width > 1]
        for name, lib in order + order[::-1] + order:
            out.fill_(float("nan"))
            if sweep(lib, g, out):
                raise SystemExit(f"{name} {label}: launch failed")
            if not torch.equal(out, want):
                raise SystemExit(f"{name} {label}: differs from the plain "
                                 "version")
            times.setdefault(name, []).append(
                per_launch(lambda: sweep(lib, g, out)))
        copy = per_launch(lambda: (out.copy_(g), 0)[1])
        colds = {name: cold(lambda: sweep(lib, g, out))
                 for name, lib in order}
        nbytes = 2 * g.numel() * g.element_size()
        print(f"  {label} (width {width}; bytes bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms): " + ", ".join(
                  f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
                  for n, ts in times.items())
              + f"; copy_ {copy:.4f}; after L2 is overwritten: "
              + ", ".join(f"{n} {t:.4f}" for n, t in colds.items())
              + f", copy_ {cold(lambda: (out.copy_(g), 0)[1]):.4f}")
    def spun(fn, per=25, reps=5):
        """Device ms a launch of ``per`` launches queued behind a ~1 ms
        spin, so the host's issue time does not show (median of
        ``reps``)."""
        samples = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            code = max(fn() for _ in range(per))
            end.record()
            end.synchronize()
            if code:
                raise SystemExit(f"launch failed: CUDA error {code}")
            samples.append(start.elapsed_time(end) / per)
        return statistics.median(samples)

    # grids far smaller than the card: a launch's latency, not its bytes
    print("one sweep of smaller grids (device ms a launch behind a spin, "
          "two rounds in turns):")
    names = [n for n in ("kernel", "baseline") if n in libs]
    for n, dtype in ((164, torch.float32), (164, torch.float16),
                     (512, torch.float32), (1_000, torch.float32),
                     (1_000, torch.bfloat16)):
        g = torch.from_numpy(gen.uniform(size=(n, n)).astype(
            np.float32)).cuda().to(dtype)
        out = torch.empty_like(g)
        small = {}
        for name in names + names[::-1]:
            if sweep(libs[name], g, out) or not torch.equal(
                    out, ref.jacobi2d(g)):
                raise SystemExit(f"{name} {n} x {n} {dtype}: differs")
            small.setdefault(name, []).append(
                spun(lambda: sweep(libs[name], g, out)))
        width = j2_mod.step_width(n, dtype, g.data_ptr())
        print(f"  {n} x {n} {dtype} (width {width}): " + ", ".join(
            f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
            for name, ts in small.items()))
    # conv2d over the interior: the yardstick the kernel table cites
    torch.backends.cudnn.allow_tf32 = False
    for g in (big, big.bfloat16()):
        w = torch.tensor([[0, 1, 0], [1, 1, 1], [0, 1, 0]],
                         dtype=g.dtype, device=g.device).view(1, 1, 3, 3) * 0.2
        x = g.view(1, 1, *g.shape)
        conv = torch.nn.functional.conv2d
        t = per_launch(lambda: (conv(x, w), 0)[1])
        print(f"  conv2d of the interior with the cross stencil, {g.dtype}: "
              f"{t:.4f} ms")
    print(f"PolyBench's {BIG_SWEEPS} sweeps on the loop route (ms, a "
          "launch a sweep, two rounds in turns):")
    for g in (big, big.bfloat16()):
        out, tmp = torch.empty_like(g), torch.empty_like(g)
        want = ref.jacobi2d(g, BIG_SWEEPS)
        width = j2_mod.step_width(BIG, g.dtype, g.data_ptr(), out.data_ptr(),
                                  tmp.data_ptr())
        names = [n for n in ("kernel", "baseline") if n in libs]
        loops = {}
        for name in names + names[::-1]:
            lib = libs[name]
            run = lambda: lib.jacobi2d_loop_launch(
                g.data_ptr(), out.data_ptr(), tmp.data_ptr(), BIG, BIG,
                j2_mod.DTYPES[g.dtype], *([width] if lib.width else []),
                BIG_SWEEPS, stream())
            loops.setdefault(name, []).append(events_ms(torch, run, reps=3))
            if not torch.equal(out, want):
                raise SystemExit(f"{name} loop {g.dtype}: differs")
        print(f"  {g.dtype}: " + ", ".join(
            f"{n} " + " / ".join(f"{t:.3f}" for t in ts)
            for n, ts in loops.items()))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("jacobi2d_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.kernels import jacobi2d as j2_mod
    from repro_torch.kernels import ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    only = sys.argv[sys.argv.index("--only") + 1] \
        if "--only" in sys.argv else None
    baseline = sys.argv[sys.argv.index("--baseline") + 1] \
        if "--baseline" in sys.argv else None
    if only in (None, "step"):
        step_variants(torch, _build, j2_mod, ref, baseline)
    if only in (None, "tiled"):
        tiled_variants(torch, _build, j2_mod, ref)
    if only in ("step", "tiled"):
        return 0
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
