#!/usr/bin/env python3
"""Time diagnostic variants of the port's flash-attention kernel beside the
kernel itself, on one CUDA card.

    python3 scripts/flash_attention_variants.py     # from the repository root

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with one piece
of the bfloat16 consumers' loop taken out or put back (a text substitution;
the script fails if the text is not found), built with the kernel's own
nvcc flags into ``build/variants/`` and called through the same C entry
point.  The variants:

- ``loads-only``: no products and no softmax; the TMA ring alone;
- ``products-only``: no softmax (P is whatever the registers hold);
- ``softmax-only``: no products (the softmax runs on stale registers);
- ``mask-per-element``: the causal/tail mask tested inside the element
  loop on every tile, as the first build of this design had it, instead of
  on a uniform branch taken on the masked tiles only.

All are timed with CUDA events (median of 10 samples of 5 back-to-back
calls) in turns, the kernel first and last, at the app's width (B 4,
S 2,048, H 8, D 64, causal; float32 and bfloat16) and llama3-8b's (B 1,
S 4,096, H 32, D 128, causal, bfloat16).  Only the kernel's output is
attention: it is held against the plain version (2e-4 float32, 2e-2
bfloat16); the variants' outputs are not checked.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4, 2_048, 8, 64, "float32"), (4, 2_048, 8, 64, "bfloat16"),
          (1, 4_096, 32, 128, "bfloat16"))
PRODUCTS = "    if (pv) issue_pv(it - 1);\n    if (qk) issue_qk(it);\n"
SOFTMAX = "    if (qk) softmax(it);\n"
MASK_BLOCK = """  if (mask) {   // one uniform branch; selects, not a branch an element
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= scale_log2;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const bool out = (col >= S) | (causal & (col > row + 8 * (e >> 1)));
        s[4 * j + e] = out ? NEG_INF : s[4 * j + e];
      }
  }
"""
MASK_PER_ELEMENT = """#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (mask) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        if (col >= S || (causal && col > row + 8 * (e >> 1))) x = NEG_INF;
      }
      s[4 * j + e] = x;
    }
  mask = true;   // the scores are scaled: the rest takes the masked path
"""
VARIANTS = {"loads-only": ((PRODUCTS, ""), (SOFTMAX, "")),
            "products-only": ((SOFTMAX, ""),),
            "softmax-only": ((PRODUCTS, ""),),
            "mask-per-element": ((MASK_BLOCK, MASK_PER_ELEMENT),)}


def sources(kernel_text: str) -> dict[str, str]:
    out = {"kernel": kernel_text}
    for name, subs in VARIANTS.items():
        text = kernel_text
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is not in "
                                 f"flash_attention.cu once:\n{old}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(build_mod, texts: dict[str, str],
          logs: dict | None = None) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once; each build's log (ptxas's
    report) into ``logs`` where one is given."""
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = out_dir / f"flash_attention-{name}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        cmd = [build_mod.nvcc(), *build_mod.flags("flash_attention"), "-o",
               str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        if logs is not None:
            logs[name] = log
        libs[name] = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        libs[name].flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    texts = sources((_build.CSRC / "flash_attention.cu").read_text())
    libs = build(_build, texts)
    order = list(libs) + list(libs)[::-1]
    gen = np.random.default_rng(2111)
    for B, S, H, D, dtype in SHAPES:
        q, k, v = (torch.from_numpy(gen.standard_normal(
            (B, S, H, D), dtype=np.float32)).to("cuda", getattr(torch, dtype))
            for _ in range(3))
        out = torch.empty_like(q)
        load = fa.LOADS[fa.path(q, k, v)]

        def call(lib):
            code = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, D, D ** -0.5, 1, int(dtype == "bfloat16"), load,
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"launch failed: CUDA error {code}")
        call(libs["kernel"])
        tol = 2e-2 if dtype == "bfloat16" else 2e-4
        err = float((out.float() - ref.flash_attention(q, k, v, True)
                     .float()).abs().max())
        if err > tol:
            raise SystemExit(f"kernel off the plain version by {err}")
        flops = 4 * D * B * H * S * (S + 1) // 2
        times = {}
        for name in order:
            for _ in range(3):
                call(libs[name])
            samples = []
            for _ in range(10):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    call(libs[name])
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) / 5)
            times.setdefault(name, []).append(statistics.median(samples))
        for name, ms in times.items():
            print(f"{dtype} B {B} S {S} H {H} D {D} {name}: "
                  + ", ".join(f"{t:.4f}" for t in ms) + " ms "
                  f"({flops / min(ms) / 1e9:.1f} TFLOP/s of attention)"
                  + (f"; max abs err {err:.3g}" if name == "kernel" else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
