#!/usr/bin/env python3
"""Diagnostic variants of the port's canneal kernels, timed beside the
kernels themselves on one CUDA card.

    python3 scripts/canneal_variants.py          # from the root

At PARSEC simlarge (400,000 locations, 1,920,000 swaps x 22 fan slots,
mean fan 10.15, integer coordinates; drawn as ``chip_smoke.py`` draws
them, seed 2111) and on its first 65,536 swaps padded (-1) to 128 slots
(the main path's call to the row kernel), and on 65,536 rows of 1,000
slots without padding (the row kernel's timings alone), CUDA events around
back-to-back calls (median of 10 samples of 25 calls) and the device
time behind a spin, each build timed in turns (the builds' order, then
the reverse):

- ``tiles``: the tile kernel of ``src/repro_torch/csrc/canneal.cu`` as
  committed (simlarge only: it takes rows of at most 96 slots), and
  ``rows``: its row kernel (rows staged in chunks of 32 slots, one stage
  at a time), both held against the plain version bit for bit;
- text-substituted copies of the source (built with the kernel's own nvcc
  flags into ``build/variants/``; the script fails if a text to replace is
  not found once): ``index-tiles-alone`` (the index tiles staged and read,
  no gather), ``gathers-alone`` (no index tile: each swap gathers ten
  locations at indices hashed from its candidates), ``ldg`` (the gathers
  through L1, ``__ldg``, in place of ``__ldcg``) and ``tiles-unstaged``
  (the tile kernel's persistent CTAs, each thread reading its index row
  from device memory: no staging), timed on their tile kernels; and for
  the row kernel ``chunk16`` (chunks of 16 slots), ``tile128`` (tiles of
  128 swaps), ``ring2`` (tiles of 128 swaps in a ring of two stages, the
  next chunk's copies issued before this one's sums: ``tile128`` with a
  ring), ``no-skip`` (eight slots of padding gathered and summed as any
  others) and ``no-flat`` (every warp picking its words by the row's
  offset, as an unaligned one does); all but the first two held bit for
  bit;
- ``rows-parent``: the row kernel before this one (one thread a swap
  reading its index row from device memory, grid-stride, eight gathers
  in flight: ``PARENT_ROWS``), held bit for bit;
- the wrappers' calls on the main path's padded rows and on simlarge:
  ``canneal.rows`` beside the parent's wrapper on ``PARENT_ROWS``
  (``parent_rows``: the device's context and current stream taken in the
  call), and ``canneal.swap_cost`` (the tile kernel) on simlarge, in
  turns (parent, this tree, this tree, parent), each back to back, in
  device time behind a spin, with L2 flushed before each call and in
  host issue time (``chip_smoke.call_times``), with the bound's share.

The ptxas lines of the tile and row kernels, and the card's name and
power limit, are printed.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, B, F, MEAN_FAN = 400_000, 1_920_000, 22, 10.15
WIDE_B, WIDE_F, LONG_F = 65_536, 128, 1_000
NO_GATHERS = ("    if (j < cnt && idx[j] >= 0)\n      p[j] = gather(",
              "    if (j < cnt && idx[j] >= 0 && n < 0)\n      p[j] = gather(")
NO_STAGE = ("  const int32_t* src = fan + first * f;",
            "  if (f > 0) return;\n  const int32_t* src = fan + first * f;")
# ten indices a swap hashed from its candidates' coordinates
HASHED = ("    for (int j = 0; j < CHUNK; ++j) idx[j] = k0 + j < f ? "
          "row[k0 + j] : -1;",
          "    for (int j = 0; j < CHUNK; ++j) idx[j] = k0 + j < 10 ? (int)(("
          "__float_as_uint(a.x) * 2654435761u + __float_as_uint(a.y) * "
          "40503u + __float_as_uint(c.x) * 69069u + __float_as_uint(c.y) * "
          "362437u + (k0 + j) * 97u) % (unsigned)n) : -1;")
LDG = ("{ return __ldcg(p); }", "{ return __ldg(p); }")
UNSTAGED = ("      const int32_t* row =\n          sidx + buf * words +\n"
            "          ((reinterpret_cast<uintptr_t>(fan + tile * TILE * f) "
            ">> 2) & 3) +\n          t * f;",
            "      const int32_t* row = fan + i * f;")
# the row kernel's shape and its two shortcuts
ROW_VARIANTS = {
    "chunk16": ("constexpr int ROW_CHUNK = 32; ",
                "constexpr int ROW_CHUNK = 16; "),
    "tile128": ("constexpr int TILE = 256; ", "constexpr int TILE = 128; "),
    "no-skip": ("  if (top < 0) return;\n", ""),
    "no-flat": ("      const bool flat = __all_sync(0xffffffffu, m == 0);",
                "      const bool flat = __all_sync(0xffffffffu, m < 0);")}
# the tile and chunk of the row variants that change them
ROW_GEOMETRY = {"chunk16": (256, 16), "tile128": (128, 32),
                "ring2": (128, 32)}
# ring2: the row kernel's loop as a ring of two stages over the sequence
# of (tile, chunk): the next chunk's copies in flight during this one's
# sums (its sums are the kernel's own, from COMPUTE to END_COMPUTE)
RING_FROM = "  __shared__ __align__(16) int32_t block[TILE * ROW_PITCH];\n"
RING_TO = "}\n\n}  // namespace"
COMPUTE = "      // the row's words' offset mod 4"
END_COMPUTE = ("      __syncthreads();   // every row is read before the next "
               "chunk comes in\n")
RING_HEAD = """  __shared__ __align__(16) int32_t ring[2 * TILE * ROW_PITCH];
  const long long tiles = (b + TILE - 1) / TILE;
  const long long mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = mine * chunks;
  const int t = threadIdx.x;
  auto issue = [&](long long k) {
    if (k < total) {
      const long long first = (blockIdx.x + k / chunks * gridDim.x) * TILE;
      const int c0 = (int)(k % chunks) * ROW_CHUNK;
      const long long left = b - first;
      stage_rows(ring + (k & 1) * (TILE * ROW_PITCH), fan, first,
                 (int)(left < TILE ? left : TILE), f, c0,
                 f - c0 < ROW_CHUNK ? f - c0 : ROW_CHUNK);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);
  float sa = 0.0f, sb = 0.0f;
  float2 a = make_float2(0.0f, 0.0f), c = a;
  for (long long k = 0; k < total; ++k) {
    issue(k + 1);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const int chunk = (int)(k % chunks);
    const long long first = (blockIdx.x + k / chunks * gridDim.x) * TILE;
    const long long i = first + t;
    const int c0 = chunk * ROW_CHUNK;
    const int len = f - c0 < ROW_CHUNK ? f - c0 : ROW_CHUNK;
    const int32_t* block = ring + (k & 1) * (TILE * ROW_PITCH);
"""


def ring2(src: str) -> str:
    """The row kernel with a ring of two stages, at tiles of 128 swaps (two
    stages in the one stage's 36 KB of static shared memory)."""
    for text in (RING_FROM, RING_TO, COMPUTE, END_COMPUTE):
        if src.count(text) != 1:
            raise SystemExit(f"the text to mark is not in the source once:"
                             f"\n{text}")
    head, tail = src.index(RING_FROM), src.index(RING_TO)
    body = src[src.index(COMPUTE):src.index(END_COMPUTE) + len(END_COMPUTE)]
    src = (src[:head] + RING_HEAD + body + "  }\n"
           '  asm volatile("cp.async.wait_group 0;" ::: "memory");\n'
           + src[tail:])
    return substitute(src, *ROW_VARIANTS["tile128"])
# the row kernel before the staged one: a thread a swap walking its index
# row in device memory, grid-stride, eight gathers in flight
PARENT_ROWS = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int CHUNK = 8;
__device__ __forceinline__ float2 gather(const float2* p) { return __ldcg(p); }
__device__ __forceinline__ float2 row_costs(const int32_t* row, int f,
                                            const float2* __restrict__ locs,
                                            int n, float2 a, float2 c) {
  float sa = 0.0f, sb = 0.0f;
  for (int k0 = 0; k0 < f; k0 += CHUNK) {
    int idx[CHUNK];
    float2 p[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) idx[j] = k0 + j < f ? row[k0 + j] : -1;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      p[j] = make_float2(0.0f, 0.0f);
      if (idx[j] >= 0) p[j] = gather(locs + (idx[j] < n ? idx[j] : n - 1));
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (k0 + j < f) {
        const bool valid = idx[j] >= 0;
        const float da = fabsf(p[j].x - a.x) + fabsf(p[j].y - a.y);
        const float db = fabsf(p[j].x - c.x) + fabsf(p[j].y - c.y);
        sa += valid ? da : 0.0f;
        sb += valid ? db : 0.0f;
      }
    }
  }
  return make_float2(sa, sb);
}
__global__ void swap_cost_rows_kernel(const float2* __restrict__ locs,
                                      const int32_t* __restrict__ fan,
                                      const float2* __restrict__ cand_a,
                                      const float2* __restrict__ cand_b,
                                      float* __restrict__ out_a,
                                      float* __restrict__ out_b, long long b,
                                      int f, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += stride) {
    const float2 s = row_costs(fan + i * f, f, locs, n, cand_a[i], cand_b[i]);
    out_a[i] = s.x;
    out_b[i] = s.y;
  }
}
}  // namespace
extern "C" int parent_rows_launch(const float* locs, const int32_t* fan,
                                  const float* cand_a, const float* cand_b,
                                  float* out_a, float* out_b, long long b,
                                  int f, int n, void* stream) {
  const int threads = 256;
  long long blocks = (b + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  swap_cost_rows_kernel<<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(locs), fan,
      reinterpret_cast<const float2*>(cand_a),
      reinterpret_cast<const float2*>(cand_b), out_a, out_b, b, f, n);
  return static_cast<int>(cudaGetLastError());
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
        d = ROOT / "build" / "variants" / f"canneal-{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "canneal.cu").write_text(src)
        flags = [f for f in build_mod.flags("canneal")
                 if f not in ("-I", str(build_mod.CSRC))]
        cmd = [build_mod.nvcc(), *flags, "-o", str(d / "libcanneal.so"),
               str(d / "canneal.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       d / "libcanneal.so")
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        lines, entry = [], None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = next((e for e in ("tiles_kernel", "rows_kernel")
                              if e in ln), None)
            elif entry and ("spill" in ln or "Used" in ln):
                lines.append(f"{entry}: {ln.strip()}")
        print(f"{name} ptxas: " + " | ".join(lines))
        lib = ctypes.CDLL(str(path))
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "rows-parent":
            lib.parent_rows_launch.argtypes = [p, p, p, p, p, p, ll, i, i, p]
            lib.parent_rows_launch.restype = ctypes.c_int
        else:
            lib.swap_cost_tiles_launch.argtypes = [p, p, p, p, p, p, ll, i,
                                                   i, p]
            lib.swap_cost_rows_launch.argtypes = [p, p, p, p, p, p, ll, i,
                                                  i, i, i, i, i, p]
            lib.swap_cost_rows_fit.argtypes = [p]
            for fn in (lib.swap_cost_tiles_launch, lib.swap_cost_rows_launch,
                       lib.swap_cost_rows_fit):
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def events_ms(torch, fn, reps: int = 10, per: int = 25) -> float:
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


def spun_ms(torch, fn, sm_clock_hz: float, reps: int = 10,
            per: int = 25) -> float:
    """Device time (ms) of one ``fn`` call: the stream first spins ~2 ms
    while the host enqueues the ``per`` calls, so the events see the
    device's work alone."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e-3 * sm_clock_hz))
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per)
    return statistics.median(samples)


def inputs(torch):
    """PARSEC simlarge's shapes, drawn with numpy from seed 2111 as
    chip_smoke.py's canneal inputs are (each swap's fan first in its row,
    -1 padding after)."""
    rng = np.random.RandomState(2111)
    locs = rng.randint(0, 1000, (N, 2)).astype(np.float32)
    fan_n = 1 + rng.binomial(F - 1, (MEAN_FAN - 1) / (F - 1), B)
    fan = rng.randint(0, N, (B, F)).astype(np.int32)
    fan[np.arange(F)[None, :] >= fan_n[:, None]] = -1
    ca, cb = (rng.randint(0, 1000, (B, 2)).astype(np.float32)
              for _ in range(2))
    return [torch.from_numpy(a).cuda() for a in (locs, fan, ca, cb)]


def parent_rows(torch, ca_mod, lib, *args):
    """The row wrapper before the staged kernel, on ``PARENT_ROWS``: the
    same checks, and the device's context and current stream taken in the
    call."""
    locs, fan, cand_a, cand_b = ca_mod._checked(*args)
    for name, t in (("locs", locs), ("cand_a", cand_a), ("cand_b", cand_b)):
        ca_mod._check.aligned(ca_mod.NAME, name, t, 8)
    B, F = fan.shape
    out_a = torch.empty(B, dtype=torch.float32, device=locs.device)
    out_b = torch.empty_like(out_a)
    with torch.cuda.device(locs.device):
        code = lib.parent_rows_launch(
            locs.data_ptr(), fan.data_ptr(), cand_a.data_ptr(),
            cand_b.data_ptr(), out_a.data_ptr(), out_b.data_ptr(), B, F,
            locs.shape[0], torch.cuda.current_stream().cuda_stream)
    if code:
        raise SystemExit(f"rows-parent: CUDA error {code}")
    return out_a, out_b


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("canneal_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import _build
    from repro_torch.kernels import canneal as ca_mod
    from repro_torch.kernels import ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build.CSRC / "canneal.cu").read_text()
    libs = build(_build, {
        "tiles": src,
        "index-tiles-alone": substitute(src, *NO_GATHERS),
        "gathers-alone": substitute(substitute(src, *NO_STAGE), *HASHED),
        "ldg": substitute(src, *LDG),
        "tiles-unstaged": substitute(substitute(src, *NO_STAGE), *UNSTAGED),
        **{name: substitute(src, *sub) for name, sub in ROW_VARIANTS.items()},
        "ring2": ring2(src),
        "rows-parent": PARENT_ROWS})
    sim = inputs(torch)
    wide = (sim[0], torch.nn.functional.pad(sim[1][:WIDE_B],
                                            (0, WIDE_F - F), value=-1),
            sim[2][:WIDE_B], sim[3][:WIDE_B])
    stream = lambda: torch.cuda.current_stream().cuda_stream
    sm_clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.split()[0]) * 1e6
    rng = np.random.RandomState(1000)
    long_rows = (sim[0], torch.from_numpy(rng.randint(
        -1, N, (WIDE_B, LONG_F)).astype(np.int32)).cuda(), sim[2][:WIDE_B],
        sim[3][:WIDE_B])
    for label, (locs, fan, ca, cb) in (
            (f"{WIDE_B} swaps x {WIDE_F} slots (the first {WIDE_B} of "
             f"simlarge padded)", wide),
            (f"{B} swaps x {F} slots, {N} locations", sim),
            (f"{WIDE_B} swaps x {LONG_F} slots, no padding", long_rows)):
        b, f = fan.shape
        want = ref.canneal_swap_cost(locs, fan, ca, cb)
        oa = torch.empty(b, dtype=torch.float32, device="cuda")
        ob = torch.empty_like(oa)
        args = lambda fan=fan, b=b, f=f: (
            locs.data_ptr(), fan.data_ptr(), ca.data_ptr(), cb.data_ptr(),
            oa.data_ptr(), ob.data_ptr(), b, f, N)

        def rows_run(lib, tile=256, chunk=32):
            # the build's own tile and chunk, which its launch checks
            ctas = ctypes.c_int(0)
            if lib.swap_cost_rows_fit(ctypes.byref(ctas)):
                raise SystemExit("swap_cost_rows_fit failed")
            chunks = max(1, -(-f // chunk))
            return lambda: lib.swap_cost_rows_launch(
                *args(), tile, chunk, chunks, ctas.value, stream())
        runs = {}
        if f <= 96:
            runs.update({name: (lambda lib=libs[name]:
                                lib.swap_cost_tiles_launch(*args(), stream()))
                         for name in ("tiles", "index-tiles-alone",
                                      "gathers-alone", "ldg",
                                      "tiles-unstaged")})
        runs["rows"] = rows_run(libs["tiles"])
        for name in (*ROW_VARIANTS, "ring2"):
            runs[name] = rows_run(libs[name], *ROW_GEOMETRY.get(name, ()))
        runs["rows-parent"] = lambda: libs["rows-parent"].parent_rows_launch(
            *args(), stream())
        for name, run in runs.items():
            oa.zero_()
            ob.zero_()
            if run():
                raise SystemExit(f"{name}: the launch failed")
            torch.cuda.synchronize()
            same = torch.equal(oa, want[0]) and torch.equal(ob, want[1])
            if not same and name not in ("index-tiles-alone",
                                         "gathers-alone"):
                raise SystemExit(f"{name}: differs from the plain version")
        print(f"{label} (ms a call back to back [device behind a spin]; "
              "each pass in turn, then in reverse; every build but "
              "index-tiles-alone and gathers-alone equal to the plain "
              "version):")
        times = {}
        for name, run in list(runs.items()) + list(runs.items())[::-1]:
            times.setdefault(name, []).append(
                (events_ms(torch, run), spun_ms(torch, run, sm_clock_hz)))
        for name, ts in times.items():
            print(f"  {name}: " + " / ".join(f"{a:.4f} [{d:.4f}]"
                                             for a, d in ts))
    print("the wrappers' calls (ms a call: back to back [device behind a "
          "spin] {device, L2 flushed before each call}; host issue; in "
          "turns: parent, rows, rows, parent):")
    for label, args in ((f"{WIDE_B:,} x {WIDE_F}", wide),
                        (f"{B:,} x {F}", sim)):
        want = ref.canneal_swap_cost(*args)
        calls = {"parent": lambda args=args: parent_rows(
                     torch, ca_mod, libs["rows-parent"], *args),
                 "rows": lambda args=args: ca_mod.rows(*args)}
        if args[1].shape[1] <= ca_mod.MAX_F:
            calls["tiles"] = lambda args=args: ca_mod.swap_cost(*args)
        for name, fn in calls.items():
            if not all(torch.equal(g, w) for g, w in zip(fn(), want)):
                raise SystemExit(f"{name} at {label} differs from the "
                                 "plain version")
        times = {name: [] for name in calls}
        for name in ("parent", "rows", *calls.keys() - {"parent", "rows"},
                     "rows", "parent"):
            times[name].append(cs.call_times(torch, calls[name],
                                             sm_clock_hz))
        b, f = args[1].shape
        bound = (N * 8 + b * f * 4 + 2 * b * 8 + 2 * b * 4) \
            / cs.PEAK_BYTES_S * 1e3
        for name, ts in times.items():
            print(f"  {label} {name} (bound {bound:.4f} ms): "
                  + " / ".join(cs.call_times_text(t, bound) for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
