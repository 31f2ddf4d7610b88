#!/usr/bin/env python3
"""Diagnostic variants of the port's SSD scan kernels, timed pass by pass
beside the kernels themselves on one CUDA card.

    python3 scripts/ssd_scan_variants.py   # from the root

At ``chip_smoke.py``'s two SSD shapes (B 8, S 65,536, H 16, P 64, N 128,
and B 2, S 16,384, H 16, P 256, N 128; float32, inputs drawn as there),
each of the three passes (chunk pass, state pass, output pass) is timed
alone (CUDA events, median of 5 calls) for:

- ``kernel``: ``src/repro_torch/csrc/ssd_scan.cu`` as committed, under the
  wrapper's plan and with the output pass under other (tile steps, heads
  a block), through the C entry points with those arguments (the chunk
  pass keeps the plan's tile);
- text-substituted copies of the source (built with the kernel's own nvcc
  flags into ``build/variants/``; the script fails if a text to replace is
  not found once): ``no-products`` (``mma_tiles`` returns at once: loads,
  scans, exponentials, stores and barriers alone), ``no-loads`` (a tile's
  B, C and x are not copied in: products on whatever the buffers hold),
  ``output-one-kstep`` (the output pass's y products one k-step a loop
  iteration, as the chunk pass's), ``chunk-two-ksteps`` (the chunk
  pass's two, as the output pass's) and ``chunk-256`` (chunks of 256
  steps: twice the chunk states).

Each build's ptxas register and spill lines are printed; the committed
kernel's output is held against the wrapper's (the same bits) and against
the plain version on the first 4,096 steps of one batch (4e-3).  The card's
name and power limit lead the output.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((8, 65_536, 16, 64, 128), (2, 16_384, 16, 256, 128))
# the texts the variants replace, and what replaces them
NO_PRODUCTS = ("  auto step = [&](int k0) {\n",
               "  if (K > 0) return;\n  auto step = [&](int k0) {\n")
NO_LOADS = ("    issue(t0);   // in flight while the running sum is taken\n",
            "")
OUT_KSTEP = ("          mma_tiles<2, 4>(\n", "          mma_tiles<2, 4, 1>(\n")
CHUNK_KSTEPS = ("      mma_tiles<2, 4, OUT ? 2 : 1>(",
                "      mma_tiles<2, 4, 2>(")
CHUNK_256 = ("constexpr int CHUNK = 512;", "constexpr int CHUNK = 256;")


def substitute(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise SystemExit(f"the text to replace is not in the source "
                         f"{count} time(s):\n{old}")
    return text.replace(old, new)


def build(build_mod, variants: dict) -> dict:
    """One nvcc per variant (its .cu and tf32.cuh), all at once."""
    procs = {}
    for name, (src, hdr) in variants.items():
        d = ROOT / "build" / "variants" / f"ssd_scan-{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "ssd_scan.cu").write_text(src)
        (d / "tf32.cuh").write_text(hdr)
        flags = [f for f in build_mod.flags("ssd_scan")
                 if f not in ("-I", str(build_mod.CSRC))]
        cmd = [build_mod.nvcc(), *flags, "-I", str(d), "-o",
               str(d / "libssd_scan.so"), str(d / "ssd_scan.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       d / "libssd_scan.so")
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        regs = sorted({ln.strip() for ln in log.splitlines()
                       if "spill" in ln or "Used" in ln})
        print(f"{name} ptxas: " + " | ".join(regs))
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_states_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                                i, i, i, i, i, p]
        lib.ssd_state_pass_launch.argtypes = [p, p, i, i, i, ll, p]
        lib.ssd_output_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                          i, i, i, i, i, ll, p]
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
        print("ssd_scan_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    hdr = (_build.CSRC / "tf32.cuh").read_text()
    libs = build(_build, {
        "kernel": (src, hdr),
        "no-products": (src, substitute(hdr, *NO_PRODUCTS)),
        "no-loads": (substitute(src, *NO_LOADS), hdr),
        "output-one-kstep": (substitute(src, *OUT_KSTEP, count=2), hdr),
        "chunk-two-ksteps": (substitute(src, *CHUNK_KSTEPS), hdr),
        "chunk-256": (substitute(src, *CHUNK_256), hdr)})
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for b, S, H, P, N in SHAPES:
        gen = np.random.default_rng(2111)
        f32 = np.float32
        normal = lambda shape: gen.standard_normal(shape, dtype=f32)
        x = torch.from_numpy(normal((b, S, H, P)) * f32(0.5)).cuda()
        dt = torch.from_numpy(np.logaddexp(f32(0), normal((b, S, H)))).cuda()
        A = torch.from_numpy(-np.exp(normal(H) * f32(0.3))).cuda()
        B = torch.from_numpy(normal((b, S, N)) * f32(0.5)).cuda()
        C = torch.from_numpy(normal((b, S, N)) * f32(0.5)).cuda()
        pl = ssd.plan(S, H, P, N)
        want = ssd.ssd_scan(x, dt, A, B, C, 256)
        head = ref.ssd_scan(x[:1, :4096], dt[:1, :4096], A, B[:1, :4096],
                            C[:1, :4096], 256)
        err = float((want[:1, :4096] - head).abs().max())
        if err > 4e-3:
            raise SystemExit(f"ssd_scan off the plain version by {err}")
        # room for the chunk-256 variant's chunks too
        Z = torch.empty((b, -(-S // 256), H, P, N), device="cuda")
        seg = torch.empty((b, -(-S // 256), H), device="cuda")
        out = torch.empty_like(x)
        shapes = [(pl.steps, pl.heads)] + [
            s for s in ((64, 2), (64, 1), (32, 4), (32, 2), (32, 1))
            if s != (pl.steps, pl.heads)]
        runs = [("kernel", s) for s in shapes] + [
            (name, shapes[0]) for name in libs if name != "kernel"]
        times = {}
        for name, (T, hg) in runs + runs[::-1]:
            lib = libs[name]
            chunk = lambda: lib.ssd_chunk_states_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                Z.data_ptr(), seg.data_ptr(), b, S, H, P, N, 0,
                pl.chunk_steps, pl.width, N, stream())
            nc = -(-S // 256) if name == "chunk-256" else pl.chunks
            state = lambda: lib.ssd_state_pass_launch(
                Z.data_ptr(), seg.data_ptr(), b, nc, H, P * N, stream())
            output = lambda: lib.ssd_output_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), Z.data_ptr(), out.data_ptr(), b, S, H, P, N, 0,
                T, pl.width, hg, N, 0, stream())
            for fn in (chunk, state, output):
                if fn():
                    raise SystemExit(f"{name} {(T, hg)}: launch failed")
            if name == "kernel":
                torch.cuda.synchronize()
                gap = float((out - want).abs().max())
                if (T, hg) == shapes[0] and gap != 0.0:
                    raise SystemExit(f"the wrapper's plan through the C "
                                     f"entries differs from ssd_scan: {gap}")
                if gap > 4e-3:
                    raise SystemExit(f"tiles {(T, hg)} off the wrapper by "
                                     f"{gap}")
            row = times.setdefault((name, T, hg), [])
            row.append(tuple(events_ms(torch, fn)
                             for fn in (chunk, state, output)))
        print(f"B {b} S {S} H {H} P {P} N {N}: wrapper's plan {tuple(pl)}, "
              f"first 4,096 steps off the plain version by {err:.3g}")
        for (name, T, hg), rows in times.items():
            print(f"  {name} (output pass: tile {T} steps, {hg} head(s) a "
                  "block): "
                  + "; ".join(f"chunk {a:.4f} + state {s_:.4f} + output "
                              f"{o:.4f} = {a + s_ + o:.4f} ms"
                              for a, s_, o in rows))
        del x, dt, B, C, Z, out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
