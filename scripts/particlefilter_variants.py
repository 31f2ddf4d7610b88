#!/usr/bin/env python3
"""The particle filter's find-index on one CUDA card: the kernels' device
time, the wrapper's host time taken apart, and one launch variant.

    python3 scripts/particlefilter_variants.py   # from the repository root

Inputs are ``chip_smoke.py``'s: Rodinia's CDF of 100,000 normalized
weights with systematic resampling's 100,000 sorted queries (the search
path) and the same CDF shuffled (the count path), from seed 2111.  Each
variant of ``src/repro_torch/csrc/particlefilter.cu`` is called through
its C entry point:

- ``kernel``: the source as committed;
- ``pdl``: the search kernel launched as the check kernel's programmatic
  dependent (``cudaLaunchKernelEx``; the check triggers it at its start,
  and the search waits with ``griddepcontrol.wait`` just before it reads
  the flags, after staging the sample).

Each is held bit for bit against the plain version on both inputs, then
timed as device time (median of 15 samples of 10 calls behind a ~2 ms
spin) and back-to-back (no spin), beside ``torch.searchsorted``.  The host
part: microseconds a call, median of 3,000 calls, of the wrapper and of
each piece a wrapper may spend them on.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N = M = 100_000
SUBS = {"pdl": (
    ("  const long long pairs = n > 1 ? n - 1 : 0;",
     "  asm volatile(\"griddepcontrol.launch_dependents;\");\n"
     "  const long long pairs = n > 1 ? n - 1 : 0;"),
    ("  if (threadIdx.x < 32) {   // the check kernel's flags, one warp",
     "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
     "  if (threadIdx.x < 32) {   // the check kernel's flags, one warp"),
    ("ok &= flags[s] != 0;", "ok &= __ldcg(flags + s) != 0;"),
    ("""  const long long blocks = (m + PF_THREADS - 1) / PF_THREADS;
  find_index_kernel<<<(unsigned)blocks, PF_THREADS, 0, st>>>(cdf, u, flags,
                                                            slots, out, n, m);""",
     """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((m + PF_THREADS - 1) / PF_THREADS));
  cfg.blockDim = dim3(PF_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, find_index_kernel, cdf, u,
                     static_cast<const int32_t*>(flags), slots, out, n, m);"""))}


def build(build_mod) -> dict:
    text = (build_mod.CSRC / "particlefilter.cu").read_text()
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("kernel", *SUBS):
        src = text
        for old, new in SUBS.get(name, ()):
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is not in "
                                 f"particlefilter.cu once:\n{old}")
            src = src.replace(old, new)
        path = out_dir / f"particlefilter-{name}.cu"
        path.write_text(src)
        so = path.with_suffix(".so")
        subprocess.run([build_mod.nvcc(), *build_mod.flags("particlefilter"),
                        "-o", str(so), str(path)], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(so))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.find_index_launch.argtypes = [p, p, p, p, i, ll, ll, p]
        lib.find_index_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def events_ms(torch, fn, spin: bool, sm_clock_hz: float, per: int = 10,
              reps: int = 15) -> float:
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(int(2e-3 * sm_clock_hz))
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per)
    return statistics.median(samples)


def host_us(torch, fn, n: int = 3_000) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("particlefilter_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build, _device
    from repro_torch.kernels import _check, ref
    from repro_torch.kernels import particlefilter as pf
    smi = lambda q: subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi("name,power.limit"))
    clock = float(smi("clocks.max.sm").split()[0]) * 1e6
    dev = torch.device("cuda")
    rng = np.random.RandomState(2111)
    w = rng.uniform(size=N)
    cdf_np = np.cumsum(w / w.sum()).astype(np.float32)
    q_np = (rng.uniform(0, 1 / N) + np.arange(M) / N).astype(np.float32)
    cdf, q = (torch.from_numpy(a).to(dev) for a in (cdf_np, q_np))
    shuffled = torch.from_numpy(rng.permutation(cdf_np)).to(dev)
    out = torch.empty(M, dtype=torch.int32, device=dev)
    flags = torch.empty(pf.FLAG_SLOTS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    libs = build(_build)
    for name, lib in libs.items():
        for c, tag in ((cdf, "Rodinia CDF"), (shuffled, "shuffled CDF")):
            call = lambda lib=lib, c=c: lib.find_index_launch(
                c.data_ptr(), q.data_ptr(), out.data_ptr(), flags.data_ptr(),
                pf.FLAG_SLOTS, N, M, stream)
            if call():
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(out, ref.particlefilter_findindex(c, q)):
                raise SystemExit(f"{name} {tag}: differs from the plain "
                                 "version")
            path = "search" if pf.searched(flags) else "count"
            print(f"{name}, {tag} ({path} path): device "
                  f"{events_ms(torch, call, True, clock):.4f} ms, "
                  f"back-to-back {events_ms(torch, call, False, clock):.4f} "
                  f"ms (the C entry point alone)")
    lib_call = lambda: torch.searchsorted(cdf, q, out_int32=True)
    print(f"searchsorted: device {events_ms(torch, lib_call, True, clock):.4f}"
          f" ms, back-to-back {events_ms(torch, lib_call, False, clock):.4f} "
          "ms")
    wrapper = lambda: pf.find_index(cdf, q)
    print(f"wrapper, Rodinia CDF: device "
          f"{events_ms(torch, wrapper, True, clock):.4f} ms, back-to-back "
          f"{events_ms(torch, wrapper, False, clock):.4f} ms")
    lib = libs["kernel"]
    pieces = {
        "the wrapper, find_index": wrapper,
        "two operand checks": lambda: (
            _check.tensor("f", "cdf", cdf, (torch.float32,), 1),
            _check.tensor("f", "u", q, (torch.float32,), 1, cdf.device)),
        "torch.empty of the output": lambda: torch.empty(
            M, dtype=torch.int32, device=q.device),
        "torch.empty of the flags and the output": lambda: torch.empty(
            pf.FLAG_SLOTS + M, dtype=torch.int32, device=q.device),
        "a view of the output": lambda: out[pf.FLAG_SLOTS:],
        "with torch.cuda.device(...)": lambda: torch.cuda.device(
            q.device).__enter__(),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "the C entry point (two launches)": lambda: lib.find_index_launch(
            cdf.data_ptr(), q.data_ptr(), out.data_ptr(), flags.data_ptr(),
            pf.FLAG_SLOTS, N, M, stream),
        "the C entry point through _device.launch": lambda: _device.launch(
            lib.find_index_launch, q, cdf.data_ptr(), q.data_ptr(),
            out.data_ptr(), flags.data_ptr(), pf.FLAG_SLOTS, N, M),
        "torch.searchsorted": lib_call,
    }
    for label, fn in pieces.items():
        print(f"host, {label}: {host_us(torch, fn):.2f} us a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
