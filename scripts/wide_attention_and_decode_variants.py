#!/usr/bin/env python3
"""Diagnostic variants of the port's D-256 and D-512 flash attention and of
its split-KV decoding, timed beside the kernels themselves on one CUDA card.

    python3 scripts/wide_attention_and_decode_variants.py   # from the root

Flash attention at gemma-7b's width (B 1, S 4,096, H 16, D 256, causal,
bfloat16: the wgmma kernel's D-256 instantiation, TMA path).  Each variant
is ``src/repro_torch/csrc/flash_attention.cu`` with one text substitution
(the script fails if the text is not found once), built with the kernel's
own nvcc flags into ``build/variants/`` by ``build`` of
``scripts/flash_attention_variants.py`` and called through the same C
entry point:

- ``loader-56-regs``: ``setmaxnreg`` gives the loader warpgroup 56
  registers (the consumers 224), to see where ptxas spills;
- ``loads-only``, ``products-only``, ``softmax-only``: as in
  ``flash_attention_variants.py``.

Each variant's ptxas spill line of the D-256 instantiation is printed;
times are CUDA events (median of 10 samples of 5 back-to-back calls) in
turns, the kernel first and last.  Only the kernel's output is checked
(2e-2 against the plain version).

The same at D 512 (B 1, S 2,048, H 8, causal, bfloat16: the D-512
instantiation, TMA path, ``chip_smoke.py``'s shape), with two more
variants of that instantiation alone:

- ``kv-empty-together``: one "empty" barrier a stage for K and V, as at D
  <= 256, in place of K's and V's apart;
- ``wg-branch``: P V's wgmma guarded by each warpgroup's own panel count,
  a branch that differs between the warpgroups (ptxas then serializes
  every wgmma: its C7520 note is printed).

The sliced kernel (16-bit heads past 512) under other plans than the
wrapper's (``slice_plan``), each passed to its C entry point as the plan's
arguments, no rebuild: at D 640 (B 1, S 1,024, H 4, causal, bfloat16,
``chip_smoke.py``'s shape) the wrapper's plan (Q resident, a whole key
tile a chunk, two stages, the warpgroups in turns) beside Q resident with
chunks of 5 and of 1 panel (the warpgroups in lockstep; chunks of 1 panel
were the kernel's first design) and Q streamed in chunks of 3; at D 1,024
(B 1, S 1,024, H 4) the wrapper's plan (Q streamed, chunks of 3 panels)
beside chunks of 1, 2 and 4.  Each output is held against the plain version
(2e-2); times as above, in turns.

The float32 sliced kernel (3xTF32, heads past 256) at ``chip_smoke.py``'s
D 512 (B 1, S 1,024, H 8, causal): text-substituted copies with other
register splits between its loader warpgroup and its consumers
(``LOADER_REGS_FS`` / ``CONSUMER_REGS_FS``), each one's ptxas spill line
printed and each timed; then the kernel under other plans than the
wrapper's (``tf32_slice_plan``) through its C entry point: Q resident with
K in chunks of 4 panels, Q streamed beside K in chunks of 3; and at D
1,024 (B 1, S 1,024, H 4) the wrapper's plan (Q streamed, chunks of 3)
beside Q resident in chunks of 1 panel and streamed in chunks of 2 and 4;
SDPA (TF32 off) beside each shape.  Each output is held against the plain
version (2e-4); times as above, in turns.

Decoding at the app's shape (B 32, S 4,096, H 8, D 64, ``kv_len`` uniform
in [1, S] with one batch at 0, as ``chip_smoke.py`` draws it): the plan
re-made at WAVES 1, 2, 4, 8, 16 and 32 (the wrapper's: 4 from a 16-bit
cache, 2 from a float32 one), each result held
against the plain version (2e-4 plus one unit of a 16-bit output), the
whole call, the split kernel and the combine kernel timed alone (median
of 10 samples of 10 calls, each sample behind a ~2 ms spin so that the
host's issue time is not counted), and the whole call again as 10
back-to-back calls with no spin (the host's issue time counted where it
exceeds the device's), the settings in turns, for a float32 and a
bfloat16 query and cache.

    python3 scripts/wide_attention_and_decode_variants.py --only f32-sliced
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GEMMA = (1, 4_096, 16, 256)
DECODE = (32, 4_096, 8, 64)
WAVES = (4, 2, 1, 8, 16, 32)
ENTRY = "flash_h16_kernelILi4E"     # the D-256 instantiation's mangled name
D512 = (1, 2_048, 8, 512)
# the sliced kernel's shapes and the plans tried beside the wrapper's:
# (Q resident, panels a chunk, chunks in the ring)
SLICED = {(1, 1_024, 4, 640): {"resident-lockstep-5": (1, 5, 4),
                               "resident-lockstep-1": (1, 1, 20),
                               "streamed-3": (0, 3, 5)},
          (1, 1_024, 4, 1_024): {"streamed-1": (0, 1, 13),
                                 "streamed-2": (0, 2, 6),
                                 "streamed-4": (0, 4, 3)}}
# the float32 sliced kernel: its register split, the splits tried beside
# it, and the plans tried beside the wrapper's at its two shapes
FS_REGS = "constexpr int LOADER_REGS_FS = 120, CONSUMER_REGS_FS = 192;"
FS_SPLITS = {"regs-72-216": (72, 216), "regs-88-208": (88, 208),
             "regs-104-200": (104, 200)}
F32_SLICED = {(1, 1_024, 8, 512): {"resident-chunk-4": (1, 4, 4),
                                   "streamed-3": (0, 3, 3)},
              (1, 1_024, 4, 1_024): {"resident-chunk-1": (1, 1, 2),
                                     "streamed-2": (0, 2, 5),
                                     "streamed-4": (0, 4, 2)}}
# text of the D-512 instantiation that its own two variants replace
EMPTY_APART = "  static constexpr int EMPTY = NP == 8 ? 2 : 1;"
PV_GUARD = "        if (pn < nmul)\n"
REGS = "constexpr int LOADER_REGS = 40, CONSUMER_REGS = 232;"


def events_ms(torch, fn, per: int, spin_cycles: int = 0) -> float:
    """Median ms a call; ``spin_cycles`` > 0 puts a spin of that many
    cycles on the stream before each sample."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per)
    return statistics.median(samples)


def spill_lines(build_mod, name: str, text: str) -> str:
    """ptxas's spill line of the D-256 instantiations of one variant."""
    out_dir = ROOT / "build" / "variants"
    src = out_dir / f"flash_attention-{name}.cu"
    src.write_text(text)
    run = subprocess.run([build_mod.nvcc(), *build_mod.flags(
        "flash_attention"), "-o", str(src.with_suffix(".probe.so")),
        str(src)], capture_output=True, text=True)
    lines, entry = [], None
    for ln in (run.stdout + run.stderr).splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif entry and ENTRY in entry and "spill" in ln:
            lines.append(ln.strip())
    return " | ".join(lines)


def attention(torch, build_mod, fa, ref, fav) -> None:
    kernel = (build_mod.CSRC / "flash_attention.cu").read_text()
    subs = {"loader-56-regs": ((REGS, REGS.replace("40", "56")
                                .replace("232", "224")),),
            "loads-only": ((fav.PRODUCTS, ""), (fav.SOFTMAX, "")),
            "products-only": ((fav.SOFTMAX, ""),),
            "softmax-only": ((fav.PRODUCTS, ""),),
            "kv-empty-together": ((EMPTY_APART,
                                   "  static constexpr int EMPTY = 1;"),),
            "wg-branch": ((PV_GUARD, "        if (pn < (wg == 0 ? half : "
                           "npan - half))\n"),)}
    texts = {"kernel": kernel}
    for name, pairs in subs.items():
        text = kernel
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is not in "
                                 f"flash_attention.cu once:\n{old}")
            text = text.replace(old, new)
        texts[name] = text
    (ROOT / "build" / "variants").mkdir(parents=True, exist_ok=True)
    for name in ("kernel", "loader-56-regs"):
        print(f"{name} ptxas, D-256 instantiations: "
              f"{spill_lines(build_mod, name, texts[name])}")
    logs = {}
    libs = fav.build(build_mod, texts, logs)
    for name in ("kernel", "kv-empty-together", "wg-branch"):
        notes = [ln.strip()[:90] for ln in logs[name].splitlines()
                 if "C7520" in ln]
        print(f"{name} ptxas, D-512 instantiations: "
              f"{len(notes)} wgmma serialization notes (C7520)"
              + (f": {notes[0]}" if notes else ""))
    gen = np.random.default_rng(2111)
    d256 = ("kernel", "loader-56-regs", "loads-only", "products-only",
            "softmax-only")
    d512 = ("kernel", "kv-empty-together", "wg-branch", "loads-only",
            "products-only", "softmax-only")
    for shape, names in ((GEMMA, d256), (D512, d512)):
        time_variants(torch, fa, ref, {n: libs[n] for n in names}, shape,
                      gen)


def time_variants(torch, fa, ref, libs, shape, gen) -> None:
    """Each variant's time at ``shape`` (bfloat16, causal), in turns; the
    kernel's output held against the plain version."""
    B, S, H, D = shape
    q, k, v = (torch.from_numpy(gen.standard_normal(
        shape, dtype=np.float32)).to("cuda", torch.bfloat16)
        for _ in range(3))
    out = torch.empty_like(q)
    load = fa.LOADS[fa.path(q, k, v)]

    def call(lib):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, D, D ** -0.5, 1, 1, load,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"launch failed: CUDA error {code}")
    call(libs["kernel"])
    err = float((out.float() - ref.flash_attention(q, k, v, True).float())
                .abs().max())
    if err > 2e-2:
        raise SystemExit(f"kernel off the plain version by {err}")
    flops = 4 * D * B * H * S * (S + 1) // 2
    times = {}
    for name in list(libs) + list(libs)[::-1]:
        times.setdefault(name, []).append(
            events_ms(torch, lambda: call(libs[name]), 5))
    for name, ms in times.items():
        rate = flops / min(ms) / 1e9
        print(f"bfloat16 B {B} S {S} H {H} D {D} {name}: "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms ({rate:.1f} TFLOP/s of attention)"
              + (f"; max abs err {err:.3g}" if name == "kernel" else ""))


def sliced_plans(torch, fa, ref) -> None:
    """The sliced kernel under the wrapper's plan and the others of
    SLICED, in turns, each output held against the plain version."""
    gen = np.random.default_rng(2111)
    lib = fa._lib()
    for shape, others in SLICED.items():
        B, S, H, D = shape
        q, k, v = (torch.from_numpy(gen.standard_normal(
            shape, dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(3))
        out = torch.empty_like(q)
        want = ref.flash_attention(q, k, v, True).float()
        plan = fa.slice_plan(D)
        plans = {"plan": (int(plan.q_resident), plan.chunk, plan.ring),
                 **others}

        def call(qres, chunk, ring):
            code = lib.flash_attention_sliced_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, D, D ** -0.5, 1, 1, fa.LOADS[fa.path(q, k, v)], plan.n,
                plan.panels, chunk, ring, qres,
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"sliced plan {(qres, chunk, ring)}: CUDA "
                                 f"error {code}")
        for name, args in plans.items():
            out.zero_()
            call(*args)
            err = float((out.float() - want).abs().max())
            if err > 2e-2:
                raise SystemExit(f"sliced {name}: off the plain version by "
                                 f"{err}")
        flops = 4 * D * B * H * S * (S + 1) // 2
        times = {}
        for name in list(plans) + list(plans)[::-1]:
            times.setdefault(name, []).append(
                events_ms(torch, lambda: call(*plans[name]), 10))
        for name, ms in times.items():
            print(f"sliced bfloat16 B {B} S {S} H {H} D {D} {name} "
                  f"(Q resident, panels a chunk, ring: {plans[name]}): "
                  + ", ".join(f"{t:.4f}" for t in ms)
                  + f" ms ({flops / min(ms) / 1e9:.1f} TFLOP/s of "
                  "attention)")


def f32_sliced(torch, build_mod, fa, ref, fav) -> None:
    """The float32 sliced kernel: register splits (ptxas spills and
    times), then plans, each in turns beside the wrapper's."""
    kernel = (build_mod.CSRC / "flash_attention.cu").read_text()
    if kernel.count(FS_REGS) != 1:
        raise SystemExit(f"f32-sliced: {FS_REGS!r} is not in "
                         "flash_attention.cu once")
    texts = {"kernel": kernel}
    for name, (lo, co) in FS_SPLITS.items():
        texts[name] = kernel.replace(
            FS_REGS, f"constexpr int LOADER_REGS_FS = {lo}, "
            f"CONSUMER_REGS_FS = {co};")
    logs = {}
    libs = fav.build(build_mod, texts, logs)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        lib.flash_attention_sliced_launch.argtypes = [
            p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, i, i, i, i, i,
            p]
        entry, spills = None, []
        for ln in logs[name].splitlines():
            if "Compiling entry function" in ln:
                entry = ln
            elif entry and "flash_f32_sliced_kernel" in entry and \
                    "spill" in ln:
                spills.append(ln.strip())
        print(f"f32-sliced {name} ptxas: {' | '.join(spills)}")
    gen = np.random.default_rng(2111)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape, others in F32_SLICED.items():
        B, S, H, D = shape
        q, k, v = (torch.from_numpy(gen.standard_normal(
            shape, dtype=np.float32)).cuda() for _ in range(3))
        out = torch.empty_like(q)
        want = ref.flash_attention(q, k, v, True)
        plan = fa.tf32_slice_plan(D)
        plans = {"plan": (int(plan.q_resident), plan.chunk, plan.ring),
                 **others}
        load = fa.LOADS[fa.path(q, k, v)]

        def call(lib, qres, chunk, ring):
            code = lib.flash_attention_sliced_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, D, D ** -0.5, 1, 0, load, plan.n, plan.panels, chunk,
                ring, qres, torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"f32-sliced plan {(qres, chunk, ring)}: "
                                 f"CUDA error {code}")
        runs = {f"{lib_name} {name}": (libs[lib_name], args)
                for lib_name in (libs if D == 512 else ("kernel",))
                for name, args in plans.items()
                if lib_name == "kernel" or name == "plan"}
        for name, (lib, args) in runs.items():
            out.zero_()
            call(lib, *args)
            err = float((out - want).abs().max())
            if err > 2e-4:
                raise SystemExit(f"f32-sliced {name}: off the plain version "
                                 f"by {err}")
        flops = 4 * D * B * H * S * (S + 1) // 2
        tq, tk, tv = (t.transpose(1, 2) for t in (q, k, v))
        runs["SDPA, TF32 off"] = None
        times = {}
        for name in list(runs) + list(runs)[::-1]:
            fn = (lambda: sdpa(tq, tk, tv, is_causal=True)) \
                if runs[name] is None else \
                (lambda r=runs[name]: call(r[0], *r[1]))
            times.setdefault(name, []).append(events_ms(torch, fn, 5))
        for name, ms in times.items():
            what = "" if runs[name] is None else \
                f" (Q resident, panels a chunk, ring: {runs[name][1]})"
            print(f"f32-sliced B {B} S {S} H {H} D {D} {name}{what}: "
                  + ", ".join(f"{t:.4f}" for t in ms)
                  + f" ms ({flops / min(ms) / 1e9:.1f} TFLOP/s of "
                  "attention)")


def decoding(torch, da, ref) -> None:
    B, S, H, D = DECODE
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.split()[0])
    spin = int(2e-3 * clock_mhz * 1e6)
    gen = np.random.default_rng(2111)
    lens = gen.integers(1, S, B, endpoint=True).astype(np.int32)
    lens[B // 2] = 0
    lens = torch.from_numpy(lens).cuda()
    normal = lambda shape: torch.from_numpy(
        gen.standard_normal(shape, dtype=np.float32)).cuda()
    base = (normal((B, H, D)), normal((B, S, H, D)), normal((B, S, H, D)))
    default = da.WAVES
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in base)
        want = ref.decode_attention(q, k, v, lens).float()
        tol = 2e-4 + torch.finfo(dtype).eps * (dtype != torch.float32)
        times = {}
        for waves in WAVES + WAVES[::-1]:
            da.WAVES = {**default, k.element_size(): waves}
            da.plan.cache_clear()
            pl = da.plan_for(q, k, v)
            err = float((da.decode_attention(q, k, v, lens).float() - want)
                        .abs().max())
            if err > tol:
                raise SystemExit(f"WAVES {waves}: off the plain version by "
                                 f"{err}")
            ws = da.split(q, k, v, lens, pl)
            out = torch.empty_like(q)
            row = times.setdefault(waves, {"len": pl.len, "call": [],
                                           "back-to-back": [], "split": [],
                                           "combine": []})
            call = lambda: da.decode_attention(q, k, v, lens)
            row["call"].append(events_ms(torch, call, 10, spin))
            row["back-to-back"].append(events_ms(torch, call, 10))
            row["split"].append(events_ms(
                torch, lambda: da.split(q, k, v, lens, pl), 10, spin))
            row["combine"].append(events_ms(
                torch, lambda: da.combine(ws, lens, pl, S, out), 10, spin))
        for waves, row in times.items():
            print(f"decoding {str(dtype)[6:]} WAVES {waves} (splits of "
                  f"{row['len']} keys): call "
                  + ", ".join(f"{t:.4f}" for t in row["call"])
                  + " ms (back-to-back "
                  + ", ".join(f"{t:.4f}" for t in row["back-to-back"])
                  + "); split "
                  + ", ".join(f"{t:.4f}" for t in row["split"]) + "; combine "
                  + ", ".join(f"{t:.4f}" for t in row["combine"]))
    da.WAVES = default
    da.plan.cache_clear()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("sliced", "attention",
                                           "f32-sliced", "decoding"),
                        help="run one section alone")
    only = parser.parse_args().only
    import torch
    if not torch.cuda.is_available():
        print("wide_attention_and_decode_variants: no CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    import flash_attention_variants as fav
    from repro_torch import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sections = {"sliced": lambda: sliced_plans(torch, fa, ref),
                "attention": lambda: attention(torch, _build, fa, ref, fav),
                "f32-sliced": lambda: f32_sliced(torch, _build, fa, ref,
                                                 fav),
                "decoding": lambda: decoding(torch, da, ref)}
    for name, run in sections.items():
        if only in (None, name):
            run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
