#!/usr/bin/env python3
"""Time variants of the engine scan's step kernel on the card.

    python3 scripts/engine_scan_variants.py [--collect]   # from the repo root

Builds ``src/repro_torch/csrc/engine_scan.cu`` and text-substituted
variants of it into ``build/variants/`` (one nvcc each, all at once) and
runs each one's scan kernel on the pre-pass records of the study's 168
lanes (the seven RiVec apps x Table 10, longest lane 31,520 records), in
turns (the committed kernel first and last).  Each variant's output must
equal the committed kernel's bit for bit.  Prints the card's name and power
limit, each build's registers, each variant's median device time (CUDA
events, 5 samples of 3 launches) and cycles a step at the max SM clock, and
the opcode counts of the committed scan kernel's SASS (``cuobjdump``).

With ``--collect`` the variants are of the collect build
(``engine_scan_kernel<true>``, run by ``engine_steps_collect_launch`` on
its own pre-pass's records): the committed kernel, its first design (all
23 accumulators in registers, one predicated add a slot), the committed
kernel with its three shared rows read and written one after another, and
two diagnostics that leave out a part (the timeline's store; the
accumulators), checked only on what they still compute.  The default kernel is timed beside them, and both kernels'
SASS is counted.

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


# the committed collect build's accumulators: two registers and three
# shared rows read together, then written
ACC_DECL = """  float acc_work = 0.0f, acc_dep = 0.0f;
  float* acc_rows =
      reinterpret_cast<float*>(ring_w + 2 * STAGES * K * WARP) + t;
  if constexpr (COLLECT)
    for (int k = 0; k < ACC_ROWS; ++k) acc_rows[k * WARP] = 0.0f;
"""
ACC_STEP = """        acc_work = acc_work + (vec ? tail_vis : dep ? 0.0f : sc_vis);
        if (dep) acc_dep = acc_dep + sc_vis;
"""
ACC_ROWS_PTRS = """        // the three rows (a scalar record's are the dummies) read together,
        // then written back: they never coincide
        float* const aw =
            acc_rows + (vec ? A_WAIT + cause - S_DISPATCH : A_WAIT_NONE) * WARP;
        float* const ae =
            acc_rows + (vec ? A_EXEC + (xx & 15) : A_EXEC_NONE) * WARP;
        float* const ao =
            acc_rows + (arith ? A_OCC + (xx >> 4) : A_OCC_NONE) * WARP;
"""
ACC_ROWS_RMW = """        const float w0 = *aw, e0 = *ae, o0 = *ao;
        *aw = w0 + wait_vis;
        *ae = e0 + exec_vis;
        *ao = o0 + xf.w;
"""
ACC_OUT = """  if constexpr (COLLECT) {
    acc_out[S_SCALAR_WORK * B + b] = acc_work;
    acc_out[S_DEP_SCALAR * B + b] = acc_dep;
    for (int k = S_DISPATCH; k < S_EXEC; ++k)
      acc_out[k * B + b] = acc_rows[(A_WAIT + k - S_DISPATCH) * WARP];
    for (int k = S_EXEC; k < N_STALL; ++k)
      acc_out[k * B + b] = acc_rows[(A_EXEC + k - S_EXEC) * WARP];
    for (int k = 0; k < N_OCC; ++k)
      acc_out[(N_STALL + k) * B + b] = acc_rows[(A_OCC + k) * WARP];
  }"""
TIMELINE = """        __stcs(rec_o, make_float4(vec ? t_new : t_scalar,
                                  vec ? issue : t_wait,
                                  vec ? complete : t_new,
                                  __int_as_float(rec_cause)));
        rec_o += B;
"""
# the first design: all 23 accumulators in registers, one predicated add
# a slot (every index a constant once the loops are unrolled)
IN_REGISTERS = [
    (ACC_DECL, """  float acc[COLLECT ? N_STALL + N_OCC : 1];
#pragma unroll
  for (int k = 0; k < (COLLECT ? N_STALL + N_OCC : 1); ++k) acc[k] = 0.0f;
"""),
    (ACC_STEP, """        acc[S_SCALAR_WORK] =
            acc[S_SCALAR_WORK] + (vec ? tail_vis : dep ? 0.0f : sc_vis);
        if (dep) acc[S_DEP_SCALAR] = acc[S_DEP_SCALAR] + sc_vis;
"""),
    (ACC_ROWS_PTRS + ACC_ROWS_RMW, """        const int wait_k = vec ? cause : -1;
        const int exec_k = vec ? S_EXEC + (xx & 15) : -1;
        const int occ_k = arith ? N_STALL + (xx >> 4) : -1;
#pragma unroll
        for (int k = S_DISPATCH; k < S_EXEC; ++k)
          if (wait_k == k) acc[k] = acc[k] + wait_vis;
#pragma unroll
        for (int k = S_EXEC; k < N_STALL; ++k)
          if (exec_k == k) acc[k] = acc[k] + exec_vis;
#pragma unroll
        for (int k = N_STALL; k < N_STALL + N_OCC; ++k)
          if (occ_k == k) acc[k] = acc[k] + xf.w;
"""),
    (ACC_OUT, """  if constexpr (COLLECT) {
#pragma unroll
    for (int k = 0; k < N_STALL + N_OCC; ++k) acc_out[k * B + b] = acc[k];
  }""")]
COLLECT_VARIANTS = {
    "collect-accumulators-in-registers": IN_REGISTERS,
    # each row read, added and written before the next is read
    "collect-rows-one-at-a-time": [(ACC_ROWS_RMW, """        *aw = *aw + wait_vis;
        *ae = *ae + exec_vis;
        *ao = *ao + xf.w;
""")],
    "diagnostic-no-timeline-store": [(TIMELINE, "")],
    "diagnostic-no-accumulators": [(ACC_STEP, ""),
                                   (ACC_ROWS_PTRS + ACC_ROWS_RMW, "")],
}


def sources(text: str, variants=VARIANTS) -> dict[str, str]:
    out = {"kernel": text}
    for name, subs in variants.items():
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
        libs[name].engine_steps_collect_launch.argtypes = [p] * 10 + [i, p]
    return libs


def sass_opcodes(build_mod, lib: Path, entry: str = "ILb0E") -> str:
    """Opcode counts of the scan kernel (not the pre-pass) in ``lib``, the
    instantiation whose mangled name holds ``entry`` (``ILb0E`` the default
    build, ``ILb1E`` the collect build); the whole SASS is written beside it
    (``.sass``)."""
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
            inside = f"18engine_scan_kernel{entry}" in ln
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


def time_in_turns(torch, calls: dict, reps: int = 5, per: int = 3) -> dict:
    """Median device ms of each call, the calls timed in turns (forward
    then backward), each sample ``per`` launches between CUDA events."""
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        calls[name]()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per):
                calls[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / per)
    return {name: statistics.median(v) for name, v in times.items()}


def collect_variants(torch, _build, engine_scan, inp, clock_hz) -> int:
    """The collect build's variants on the study's 168 lanes (--collect)."""
    libs = build(_build, sources((_build.CSRC / "engine_scan.cu")
                                 .read_text(), COLLECT_VARIANTS))
    so = ROOT / "build" / "variants" / "engine_scan-kernel.so"
    print("SASS of the default scan kernel:", sass_opcodes(_build, so))
    print("SASS of the collect scan kernel:",
          sass_opcodes(_build, so, "ILb1E"))
    xi, xf, params, consts, period, n, ck = inp.args()
    recs = engine_scan.prepass(xi, xf, params, consts, collect=True)
    B, T = xf.shape[1], int(n.max())
    outs = {name: (torch.empty(8, B, device="cuda"),
                   torch.empty(23, B, device="cuda"),
                   torch.zeros(T, B, 4, device="cuda")) for name in libs}

    def call(name):
        out, acc, rec = outs[name]
        code = libs[name].engine_steps_collect_launch(
            *(r.data_ptr() for r in recs), params.data_ptr(),
            period.data_ptr(), n.data_ptr(), ck.data_ptr(), out.data_ptr(),
            acc.data_ptr(), rec.data_ptr(), B,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"{name}: launch failed, CUDA error {code}")

    calls = {name: (lambda name=name: call(name)) for name in libs}
    calls["default kernel"] = lambda: engine_scan.steps(
        *recs[:2], params, period, n, ck)
    ms = time_in_turns(torch, calls)
    want = outs["kernel"]
    bits = lambda t: t.view(torch.int32)
    for name in calls:
        same = ""
        if name in outs:
            got = outs[name]
            checked = [0] if "diagnostic" in name else [0, 1, 2]
            if name.endswith("timeline-store"):
                checked = [0, 1]
            elif name.endswith("no-accumulators"):
                checked = [0, 2]
            if not all(torch.equal(bits(got[i]), bits(want[i]))
                       for i in checked):
                raise SystemExit(f"{name}: differs from the kernel")
            same = (", bit for bit equal" if len(checked) == 3 else
                    ", equal where it computes")
        print(f"{name}: {ms[name]:.4f} ms, "
              f"{ms[name] * 1e-3 * clock_hz / T:.1f} cycles a step at "
              f"{clock_hz / 1e6:.0f} MHz{same}")
    return 0


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
    pairs = [(a, c) for a in tracegen.RIVEC_APPS for c in ve.TABLE10]
    inp = suite.scan_inputs(pairs)
    if "--collect" in sys.argv[1:]:
        return collect_variants(torch, _build, engine_scan, inp, clock_hz)
    libs = build(_build, sources((_build.CSRC / "engine_scan.cu")
                                 .read_text()))
    print("SASS of the scan kernel:", sass_opcodes(
        _build, ROOT / "build" / "variants" / "engine_scan-kernel.so"))
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
