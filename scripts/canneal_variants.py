#!/usr/bin/env python3
"""Diagnostic variants of the port's canneal kernels, timed beside the
kernels themselves on one CUDA card.

    python3 scripts/canneal_variants.py          # from the root

At PARSEC simlarge (400,000 locations, 1,920,000 swaps x 22 fan slots,
mean fan 10.15, integer coordinates; drawn as ``chip_smoke.py`` draws
them, seed 2111), CUDA events around back-to-back calls (median of 10
samples of 25 calls), each build timed in turns (the builds' order, then
the reverse):

- ``tiles``: the tile kernel of ``src/repro_torch/csrc/canneal.cu`` as
  committed, and ``rows``: its row kernel (one thread reading its index
  row from device memory, eight gathers in flight), both held against the
  plain version bit for bit;
- text-substituted copies of the source (built with the kernel's own nvcc
  flags into ``build/variants/``; the script fails if a text to replace is
  not found once): ``index-tiles-alone`` (the index tiles staged and read,
  no gather), ``gathers-alone`` (no index tile: each swap gathers ten
  locations at indices hashed from its candidates), ``ldg`` (the gathers
  through L1, ``__ldg``, in place of ``__ldcg``), ``tiles-unstaged`` (the
  tile kernel's persistent CTAs, each thread reading its index row from
  device memory: no staging) and ``rows-serial`` (the row kernel with one
  gather at a time: the kernel before the tile kernel); the last three
  held bit for bit too.

The ptxas lines of the tile kernel, and the card's name and power limit,
are printed.
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
NO_GATHERS = ("      if (idx[j] >= 0) p[j] = gather(",
              "      if (idx[j] >= 0 && f < 0) p[j] = gather(")
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
# the row kernel with one gather at a time (the kernel before the tile
# kernel)
ROWS_SERIAL = ("""    const float2 s = row_costs(fan + i * f, f, locs, n, cand_a[i], \
cand_b[i]);
    out_a[i] = s.x;
    out_b[i] = s.y;""", """    const float2 a = cand_a[i], c = cand_b[i];
    const int32_t* row = fan + i * f;
    float sa = 0.0f, sb = 0.0f;
#pragma unroll 4
    for (int k = 0; k < f; ++k) {
      const int idx = row[k];
      const bool valid = idx >= 0;
      float2 p = make_float2(0.0f, 0.0f);
      if (valid) p = gather(locs + (idx < n ? idx : n - 1));
      const float da = fabsf(p.x - a.x) + fabsf(p.y - a.y);
      const float db = fabsf(p.x - c.x) + fabsf(p.y - c.y);
      sa += valid ? da : 0.0f;
      sb += valid ? db : 0.0f;
    }
    out_a[i] = sa;
    out_b[i] = sb;""")


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
        lines, entry = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = "tiles_kernel" in ln
            elif entry and ("spill" in ln or "Used" in ln):
                lines.append(ln.strip())
        print(f"{name} ptxas (tile kernel): " + " | ".join(lines))
        lib = ctypes.CDLL(str(path))
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.swap_cost_tiles_launch, lib.swap_cost_rows_launch):
            fn.argtypes = [p, p, p, p, p, p, ll, i, i, p]
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("canneal_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
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
        "rows-serial": substitute(src, *ROWS_SERIAL)})
    locs, fan, ca, cb = inputs(torch)
    want = ref.canneal_swap_cost(locs, fan, ca, cb)
    oa = torch.empty(B, dtype=torch.float32, device="cuda")
    ob = torch.empty_like(oa)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    args = lambda: (locs.data_ptr(), fan.data_ptr(), ca.data_ptr(),
                    cb.data_ptr(), oa.data_ptr(), ob.data_ptr(), B, F, N,
                    stream())
    runs = {name: (lambda lib=lib: lib.swap_cost_tiles_launch(*args()))
            for name, lib in libs.items()}
    runs["rows"] = lambda: libs["tiles"].swap_cost_rows_launch(*args())
    runs["rows-serial"] = \
        lambda: libs["rows-serial"].swap_cost_rows_launch(*args())
    for name in ("tiles", "rows", "ldg", "tiles-unstaged", "rows-serial"):
        oa.zero_()
        if runs[name]() or not (torch.equal(oa, want[0])
                                and torch.equal(ob, want[1])):
            raise SystemExit(f"{name}: differs from the plain version")
    print(f"{B} swaps x {F} slots, {N} locations (ms; tiles, rows, ldg, "
          "tiles-unstaged and rows-serial equal to the plain version):")
    times = {}
    for name, run in list(runs.items()) + list(runs.items())[::-1]:
        times.setdefault(name, []).append(events_ms(torch, run))
    for name, ts in times.items():
        print(f"  {name}: " + " / ".join(f"{t:.4f}" for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
