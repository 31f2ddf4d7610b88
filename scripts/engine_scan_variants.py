#!/usr/bin/env python3
"""Time variants of the engine scan's step kernel on the card.

    python3 scripts/engine_scan_variants.py     # from the repository root

Builds ``src/repro_torch/csrc/engine_scan.cu`` and text-substituted
variants of it into ``build/variants/`` (one nvcc each, all at once) and
runs each one's scan kernel on the pre-pass records of the study's 168
lanes (the seven RiVec apps x Table 10, longest lane 31,520 records), in
turns (the committed kernel first and last).  Each variant's output must
equal the committed kernel's bit for bit.  Prints the card's name and power
limit, each build's registers, each variant's median device time (CUDA
events, 5 samples of 3 launches) and cycles a step at the max SM clock, and
the opcode counts of the committed scan kernel's SASS (``cuobjdump``).

A variant's substitution fails loudly if the source text it targets moved.
"""
from __future__ import annotations

import collections
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STORES_IF = """      if (vec) {
        at(col, w_rob) = commit;
        at(col, w_q) = issue;
      }"""
STORES_DUMMY = """      at(col, vec ? w_rob : DUMMY * ROW) = commit;
      at(col, vec ? w_q : DUMMY * ROW) = issue;"""
VARIANTS = {
    "records-4-a-tile": [("constexpr int K = 8,", "constexpr int K = 4,")],
    "records-16-a-tile": [("constexpr int K = 8,",
                           "constexpr int K = 16,")],
    "three-stages": [("STAGES = 4, TILES_AHEAD = STAGES - 1",
                      "STAGES = 3, TILES_AHEAD = STAGES - 1")],
    "ring-stores-to-dummy": [(STORES_IF, STORES_DUMMY)],
}


def sources(text: str) -> dict[str, str]:
    out = {"kernel": text}
    for name, subs in VARIANTS.items():
        t = text
        for old, new in subs:
            if t.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is not in "
                                 f"engine_scan.cu once:\n{old}")
            t = t.replace(old, new)
        out[name] = t
    return out


def build(build_mod, texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = out_dir / f"engine_scan-{name}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        cmd = [build_mod.nvcc(), *build_mod.flags("engine_scan"), "-o",
               str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"build {name}: {' | '.join(regs)}")
        libs[name] = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        libs[name].engine_steps_launch.argtypes = [p] * 7 + [i, p]
    return libs


def sass_opcodes(build_mod, lib: Path) -> str:
    """Opcode counts of the scan kernel (not the pre-pass) in ``lib``; the
    whole SASS is written beside it (``.sass``)."""
    run = subprocess.run([str(Path(build_mod.nvcc()).with_name("cuobjdump")),
                          "-sass", str(lib)], capture_output=True, text=True)
    if run.returncode != 0:
        return f"not counted: cuobjdump exited {run.returncode}"
    lib.with_suffix(".sass").write_text(run.stdout)
    ops, inside = collections.Counter(), False
    for ln in run.stdout.splitlines():
        if "Function :" in ln:
            # the mangled name, length-prefixed (the anonymous namespace's
            # tag carries the file name, which may hold the same words)
            inside = "18engine_scan_kernelE" in ln
        elif inside:
            # an instruction line starts with its address, /*0a40*/; the
            # line after it holds the rest of its encoding, /* 0x... */
            tok = ln.split()
            if len(tok) < 2 or not re.fullmatch(r"/\*[0-9a-f]+\*/", tok[0]):
                continue
            op = tok[2] if tok[1].startswith("@") else tok[1]
            ops[op.split(".")[0].rstrip(";")] += 1
    return f"{sum(ops.values())} instructions: " + ", ".join(
        f"{k} {v}" for k, v in ops.most_common(16))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("engine_scan_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.configs import vector_engine as ve
    from repro_torch.core import suite, tracegen
    from repro_torch.kernels import engine_scan

    smi = ["nvidia-smi", "--format=csv,noheader"]
    print(subprocess.run([*smi, "--query-gpu=name,power.limit"],
                         capture_output=True, text=True).stdout.strip())
    clock_hz = float(subprocess.run(
        [*smi, "--query-gpu=clocks.max.sm"], capture_output=True,
        text=True).stdout.split()[0]) * 1e6
    libs = build(_build, sources((_build.CSRC / "engine_scan.cu")
                                 .read_text()))
    print("SASS of the scan kernel:", sass_opcodes(
        _build, ROOT / "build" / "variants" / "engine_scan-kernel.so"))
    pairs = [(a, c) for a in tracegen.RIVEC_APPS for c in ve.TABLE10]
    inp = suite.scan_inputs(pairs)
    xi, xf, params, consts, period, n, ck = inp.args()
    rec_f, rec_w = engine_scan.prepass(xi, xf, params, consts)
    B, T = xf.shape[1], int(n.max())
    outs = {name: torch.empty(8, B, device="cuda") for name in libs}

    def call(name):
        code = libs[name].engine_steps_launch(
            rec_f.data_ptr(), rec_w.data_ptr(), params.data_ptr(),
            period.data_ptr(), n.data_ptr(), ck.data_ptr(),
            outs[name].data_ptr(), B, torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"{name}: launch failed, CUDA error {code}")

    for name in libs:
        call(name)
    torch.cuda.synchronize()
    want = outs["kernel"]
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        call(name)
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                call(name)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 3)
    for name in libs:
        if not torch.equal(outs[name], want):
            raise SystemExit(f"{name}: output differs from the kernel's")
        ms = statistics.median(times[name])
        print(f"{name}: {ms:.4f} ms, {ms * 1e-3 * clock_hz / T:.1f} cycles "
              f"a step at {clock_hz / 1e6:.0f} MHz, bit for bit equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
