#!/usr/bin/env python3
"""Diagnostic variants of the port's streamcluster kernels, timed beside the
kernels themselves on one CUDA card.

    python3 scripts/streamcluster_variants.py   # from the root

At PARSEC simlarge (16,384 points x 128 dimensions, 4,096 centers drawn
from them; seed 2111), in float32 (3xTF32), bfloat16 and float16, each
build is timed through its C entry point (CUDA
events around 10 back-to-back calls, median of 10, two rounds in turns):

- ``kernel``: ``src/repro_torch/csrc/streamcluster.cu`` as committed;
- text-substituted copies of the source, built with the kernel's own nvcc
  flags into ``build/variants/`` (the script fails if a text to replace is
  not found once), each with a part of the work taken away, so only its
  time counts: ``no-store`` (the products, norms and epilogue arithmetic,
  no store to the output: the 16-bit kernel still stages its tile in
  shared memory), ``no-products`` (the loads, the
  norms, the float32 split and the store, no tensor-core product),
  ``no-norms`` (the fused norms gone) and ``separate-norms`` (``no-norms`` after a pre-pass of
  two row-norm launches, one warp a row, as the kernel before this one
  formed them).

The committed kernel's largest error against the plain version, and
against float64 distances on 256 rows, is printed first, and the time of
torch's ``fill_`` of the output (its write alone) last.  The card's name and power limit, each build's ptxas
lines and its HGMMA / HMMA counts are printed, and the bytes bound (the
output written, the operands read once) beside the times.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
M, N, D = 16_384, 4_096, 128
PEAK_BYTES_S = 3.35e12
# the texts the variants replace, and what replaces them
NO_STORE = ("  if (m >= M || n >= N) return;",
            "  if (m >= M || n >= N || a0 != -1.5f) return;")
NO_TMA_STORE = ("          tma_store_2d(&to, staged",
                "          if (D < 0) tma_store_2d(&to, staged")
NO_PRODUCTS = ("  if constexpr (TY == 2)\n    WGMMA_SS_N128(",
               "  if (da != 0) return;   // never a zero descriptor\n"
               "  if constexpr (TY == 2)\n    WGMMA_SS_N128(")
NO_NORMS_H = ("        for (int ch = 0; ch < 8; ++ch) {\n          const uint4",
              "        for (int ch = 0; ch < 8 && D < 0; ++ch) {\n"
              "          const uint4")
NO_NORMS_F = ("      nrm += v.x * v.x;\n      nrm += v.y * v.y;\n"
              "      nrm += v.z * v.z;\n      nrm += v.w * v.w;\n", "")
# the separate pre-pass, appended to the no-norms copy: one warp a row
ROW_NORMS = r'''
template <typename T>
__global__ void row_norms_kernel(const T* __restrict__ x,
                                 float* __restrict__ out, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) {
    const float v = (float)x[(long long)row * d + k];
    s += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

extern "C" int streamcluster_row_norms_launch(const void* x, float* out,
                                              int rows, int d, int dtype,
                                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  if (dtype == 1)
    row_norms_kernel<<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), out, rows, d);
  else if (dtype == 2)
    row_norms_kernel<<<blocks, 256, 0, st>>>(static_cast<const __half*>(x),
                                             out, rows, d);
  else
    row_norms_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(x),
                                             out, rows, d);
  return static_cast<int>(cudaGetLastError());
}
'''


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the text to replace is not in the source once:"
                         f"\n{old}")
    return text.replace(old, new)


def sass_counts(build_mod, path) -> str:
    cuobjdump = Path(build_mod.nvcc()).with_name("cuobjdump")
    run = subprocess.run([str(cuobjdump), "-sass", str(path)],
                         capture_output=True, text=True)
    ops = [ln.split()[1].split(".")[0] for ln in run.stdout.splitlines()
           if ln.lstrip().startswith("/*") and len(ln.split()) > 1]
    return ", ".join(f"{op} {ops.count(op)}" for op in ("HGMMA", "HMMA"))


def build(build_mod, variants: dict) -> dict:
    """One nvcc per variant, all at once (csrc on the include path for
    tf32.cuh)."""
    procs = {}
    for name, src in variants.items():
        d = ROOT / "build" / "variants" / f"streamcluster-{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "streamcluster.cu").write_text(src)
        cmd = [build_mod.nvcc(), *build_mod.flags("streamcluster"), "-o",
               str(d / "libstreamcluster.so"), str(d / "streamcluster.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       d / "libstreamcluster.so")
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"{name}: {sass_counts(build_mod, path)}; ptxas: "
              + " | ".join(regs))
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streamcluster_dist_launch.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.streamcluster_dist_launch.restype = ctypes.c_int
        if name == "separate-norms":
            lib.streamcluster_row_norms_launch.argtypes = [p, p, i, i, i, p]
            lib.streamcluster_row_norms_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def events_ms(torch, fn, reps: int = 10, per: int = 10) -> float:
    for _ in range(2):
        if fn():
            raise SystemExit("launch failed")
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
        print("streamcluster_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.kernels import ref
    from repro_torch.kernels import streamcluster as sc_mod
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build.CSRC / "streamcluster.cu").read_text()
    no_norms = substitute(substitute(src, *NO_NORMS_H), *NO_NORMS_F)
    libs = build(_build, {
        "kernel": src,
        "no-store": substitute(substitute(src, *NO_STORE), *NO_TMA_STORE),
        "no-products": substitute(src, *NO_PRODUCTS),
        "no-norms": no_norms,
        "separate-norms": no_norms + ROW_NORMS})
    rng = np.random.RandomState(2111)
    pts = rng.uniform(size=(M, D)).astype(np.float32)
    ctr = pts[rng.choice(M, N, replace=False)]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    out = torch.empty(M, N, device="cuda")
    norms = torch.empty(M + N, device="cuda")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        p = torch.from_numpy(pts).cuda().to(dtype)
        c = torch.from_numpy(ctr).cuda().to(dtype)
        code, load = sc_mod.DTYPES[dtype], sc_mod.LOADS[sc_mod.path(p, c)]
        got = sc_mod.streamcluster_dist(p, c)
        err = float((got - ref.streamcluster_dist(p, c)).abs().max())
        rows = slice(0, 256)
        exact = ((p[rows, None].double() - c[None].double()) ** 2).sum(-1)
        err64 = float((got[rows].double() - exact).abs().max())

        def call(lib, name):
            def run():
                if name == "separate-norms":
                    for x, rows, o in ((p, M, 0), (c, N, M)):
                        e = lib.streamcluster_row_norms_launch(
                            x.data_ptr(), norms.data_ptr() + 4 * o, rows, D,
                            code, stream())
                        if e:
                            return e
                return lib.streamcluster_dist_launch(
                    p.data_ptr(), c.data_ptr(), out.data_ptr(), M, N, D,
                    code, load, stream())
            return run

        times = {}
        for name, lib in list(libs.items()) + list(libs.items())[::-1]:
            times.setdefault(name, []).append(events_ms(torch,
                                                        call(lib, name)))
        nbytes = (M + N) * D * p.element_size() + M * N * 4
        print(f"{dtype} {M} x {N} x {D}, route {sc_mod.path(p, c)}: max abs "
              f"err {err:.3g} against the plain version, {err64:.3g} against "
              f"float64 on 256 rows (ms, two rounds in turns; bytes bound "
              f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms):")
        for name, ms in times.items():
            print(f"  {name}: " + " / ".join(f"{t:.4f}" for t in ms))
        fill = lambda: (out.fill_(1.0), 0)[1]
        print(f"  the output's write alone (torch's fill_ of the {M} x {N} "
              f"float32 output): {events_ms(torch, fill):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
