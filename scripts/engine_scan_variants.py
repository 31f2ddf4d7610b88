#!/usr/bin/env python3
"""Time variants of the engine scan's step kernel on the card.

    python3 scripts/engine_scan_variants.py [--collect [--baseline=OLD.cu]]

Builds ``src/repro_torch/csrc/engine_scan.cu`` and text-substituted
variants of it into ``build/variants/`` (one nvcc each, all at once) and
runs each one's scan kernel on the pre-pass records of the study's 168
lanes (the seven RiVec apps x Table 10, longest lane 31,520 records), in
turns (the committed kernel first and last).  Each variant's output must
equal the committed kernel's bit for bit.  Prints the card's name and power
limit, each build's registers, each variant's median device time (CUDA
events, 5 samples of 3 launches) and cycles a step at the max SM clock, and
the opcode counts of the committed scan kernel's SASS (``cuobjdump``).

With ``--collect`` (and ``--baseline=OLD.cu``, an older tree's
``engine_scan.cu``) the designs are of the collect build
(``engine_scan_kernel<true>``, run by ``engine_steps_collect_launch`` on
its own pre-pass's records, no zeroed timeline): the committed kernel (the
recurrence on one warp, the cause and the attribution on two more), the
post-pass (the scan computes the cause and writes its record words to
device memory, and a second kernel, one thread per (accumulator, lane),
attributes them in step order), the baseline's collect build, and
diagnostics checked on the timing outputs only: the producer warp alone,
the cause back on the producer's warp, each consumer role alone, the
hand-off alone, the hand-off plus 64 float adds a step from unrolled and
from rolled code, and the consumers' step loop unrolled over the tile.
Each is timed in turns beside the default kernel, held bit for bit to the
committed kernel where it computes everything, and given its SASS
instructions a step: every design is also built with 16 records a tile,
and its kernels' extra instructions are over the 8 more steps unrolled.

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


# The collect build's variants, against the committed text: its consumer
# warps' calls, the producer's two barriers, the records it stores a step,
# and the launch of three warps a block.
CONSUMER_CALL = """    if (threadIdx.x >= 2 * WARP) {
      attribute_lane<1>(c_ring + t, stage, params, rec_f, rec_x, period, b,
                        bp, T, tiles, B, acc_out, rec_out);
      return;
    }
    if (threadIdx.x >= WARP) {
      attribute_lane<0>(c_ring + t, stage, params, rec_f, rec_x, period, b,
                        bp, T, tiles, B, acc_out, rec_out);
      return;
    }
"""
EMPTY_WAIT = """        if (j >= C_TILES) bar_sync(BAR_EMPTY + j % C_TILES, C_THREADS);
"""
RING_TILE = """        c_rec = c_ring + (j % C_TILES) * K * WARP + t;
"""
FULL_ARRIVE = """      if constexpr (COLLECT) bar_arrive(BAR_FULL + j % C_TILES, C_THREADS);
"""
TWO_WARPS = "COLLECT ? C_THREADS : WARP, bytes,"
RECORDS = """        *c_rec = make_float4(t_new, issue, complete, __int_as_float(xw));
        c_rec[C_TILES * K * WARP] =
            make_float4(rob_slot, phys_slot, q_slot, fmaxf(r1, r2));
        c_rec += WARP;
"""
# the wait's cause on the producer's warp, a chain of selects in the
# reference's precedence, stored with the flags in the record's last word
# (the post-pass reads it there)
CAUSE = """        int cause = issue == inorder ? S_INORDER : S_DISPATCH;
        cause = issue == fu_free ? (mem ? S_VMU_WAIT : S_LANE_WAIT) : cause;
        cause = issue == fmaxf(r1, r2) ? S_RAW : cause;
        cause = issue == q_slot ? (mem ? S_MQ_FULL : S_AQ_FULL) : cause;
        cause = issue == phys_slot ? S_PHYS_FULL : cause;
        cause = issue == rob_slot ? S_ROB_FULL : cause;
        *c_rec = make_float4(t_new, issue, complete,
                             __int_as_float(cause | (xw & 31) << 8));
"""
# The post-pass: the scan (one warp a block, no consumer) writes each
# step's record words (t_new, issue, complete, the cause and flags) to a
# [T, B] float4 buffer in device memory (passed as the scan's rec), and a
# second kernel, one thread per (accumulator, lane) with each warp 32 lanes
# of one accumulator (so a step's row of the buffer is one 512-byte read),
# runs the consumer's carry over the lane's records in step order and adds
# its own slot's term; the threads of accumulator 0 also write the timeline.
POSTPASS = r"""
namespace {
constexpr int N_ACC = N_STALL + N_OCC;

__global__ void __launch_bounds__(WARP)
engine_postpass_kernel(const float4* __restrict__ words,
                       const float4* __restrict__ rec_f,
                       const int32_t* __restrict__ rec_x,
                       const int32_t* __restrict__ period,
                       const int32_t* __restrict__ n_steps,
                       float* __restrict__ acc_out,
                       float4* __restrict__ rec_out, int B) {
  const int b = blockIdx.x * WARP + threadIdx.x, slot = blockIdx.y;
  if (b >= B) return;
  const int T = n_steps[b], per = T > 0 ? max(period[b], 1) : 1;
  const float4* src_f = rec_f + b;
  const int32_t* src_x = rec_x + b;
  const float4* w = words + b;
  float4* rec_o = rec_out + b;
  int pos = 0;
  float t_scalar = 0.0f, last_commit = 0.0f, scalar_res = 0.0f, acc = 0.0f;
  // a tile of K records, its class words and busy terms, loaded a tile
  // ahead of the steps that read them
  float4 rc[K], nrc[K];
  int xs[K], nxs[K];
  float ws[K], nws[K];
  auto load = [&](int r0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (r0 + k < T) {
        nrc[k] = w[(size_t)(r0 + k) * B];
        nxs[k] = __ldg(src_x);
        nws[k] = __ldg(&src_f->w);
        const bool wrap = ++pos == per;
        const long long d = wrap ? -(long long)(per - 1) * B : B;
        pos = wrap ? 0 : pos;
        src_f += d;
        src_x += d;
      }
    }
  };
  auto step = [&](float4 rc, int xx, float busy) {
    const int bits = __float_as_int(rc.w);
    const bool vec = bits & F_VEC << 8, dep = bits & F_DEP << 8,
               arith = bits & F_ARITH << 8, res = bits & F_RES << 8;
    const int cause = bits & 0xff;
    const float t_new = rc.x, issue = rc.y, complete = rc.z;
    const float f_old = fmaxf(t_scalar, last_commit);
    const float t_wait = fmaxf(t_scalar, dep ? scalar_res : -INFINITY);
    const float dep_vis = fmaxf(t_wait - f_old, 0.0f);
    const float work_vis = fmaxf(t_new - fmaxf(t_wait, f_old), 0.0f);
    const float sc_vis = dep_vis + work_vis;
    const float wait_vis = fmaxf(issue - f_old, 0.0f);
    const float exec_vis = fmaxf(complete - fmaxf(issue, f_old), 0.0f);
    const float tail_vis = fmaxf(t_new - fmaxf(complete, f_old), 0.0f);
    if (slot == S_SCALAR_WORK)
      acc = acc + (vec ? tail_vis : dep ? 0.0f : sc_vis);
    else if (slot == S_DEP_SCALAR) {
      if (dep) acc = acc + sc_vis;
    } else if (slot < S_EXEC) {
      if (vec && cause == slot) acc = acc + wait_vis;
    } else if (slot < N_STALL) {
      if (vec && S_EXEC + (xx & 15) == slot) acc = acc + exec_vis;
    } else if (arith && N_STALL + (xx >> 4) == slot) {
      acc = acc + busy;
    }
    if (slot == 0) {
      const int rec_cause = vec ? cause : dep ? S_DEP_SCALAR : S_SCALAR_WORK;
      __stcs(rec_o, make_float4(vec ? t_new : t_scalar, vec ? issue : t_wait,
                                vec ? complete : t_new,
                                __int_as_float(rec_cause)));
    }
    rec_o += B;
    t_scalar = t_new;
    last_commit = vec ? fmaxf(complete, last_commit) : last_commit;
    scalar_res = res ? complete : scalar_res;
  };
  load(0);
  for (int r0 = 0; r0 < T; r0 += K) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rc[k] = nrc[k];
      xs[k] = nxs[k];
      ws[k] = nws[k];
    }
    load(r0 + K);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (r0 + k < T) step(rc[k], xs[k], ws[k]);
  }
  acc_out[slot * B + b] = acc;
}
}  // namespace

extern "C" int engine_postpass_launch(const void* words, const void* rec_f,
                                      const int32_t* rec_x,
                                      const int32_t* period,
                                      const int32_t* n_steps, float* acc,
                                      void* rec, int B, void* stream) {
  engine_postpass_kernel<<<dim3((B + WARP - 1) / WARP, N_ACC), WARP, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(words), static_cast<const float4*>(rec_f),
      rec_x, period, n_steps, acc, static_cast<float4*>(rec), B);
  return static_cast<int>(cudaGetLastError());
}
"""
ONE_WARP = [(CONSUMER_CALL, ""), (FULL_ARRIVE, ""),
            (TWO_WARPS, "WARP, bytes,")]
COLLECT_VARIANTS = {
    "post-pass": ONE_WARP + [
        (EMPTY_WAIT + RING_TILE,
         "        c_rec = rec_out + (size_t)j * K * B + b;\n"),
        (RECORDS, CAUSE + "        c_rec += B;\n"),
        ("\n}  // namespace\n", "\n}  // namespace\n" + POSTPASS)],
    # the recurrence and the records' stores with no consumer and no
    # barriers: checked only on the timing outputs
    "diagnostic-producer-alone": ONE_WARP + [(EMPTY_WAIT, "")],
    # the cause computed on the producer's warp as well (its records then
    # carry it where the consumers read flags: timing outputs only)
    "diagnostic-cause-on-producer": [(
        RECORDS, CAUSE + RECORDS[RECORDS.index("        c_rec[C_TILES"):])],
}
# Diagnostics on the consumer warps (checked on the timing outputs only):
# one role alone (two warps a block: the producer and that role; the other
# role's slots are not written); the hand-off alone (the ring read, one add
# a step); the hand-off and 64 independent float adds a step, from code
# unrolled over the tile's steps or from a loop that is not (the same work,
# an eighth of the code); and the committed consumers with their step loop
# unrolled over the tile (8 times the code).
TWO = ("constexpr int C_THREADS = 3 * WARP;",
       "constexpr int C_THREADS = 2 * WARP;")
STEP_LOOP = """#pragma unroll 1
    for (int k = 0; k < n; ++k) {
"""
STEP_CALL = """      step(r, q, x, w);
"""
ADDS = """      float sp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sp[i] = r.y + i;
#pragma unroll %s
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < 16; ++i) sp[i] = sp[i] + r.x;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[0] = acc[0] + sp[i];
"""
UNROLLED = """#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k >= n) break;
"""
COLLECT_VARIANTS.update({
    "diagnostic-wait-role-only": [TWO],
    "diagnostic-exec-role-only": [TWO, (CONSUMER_CALL, """    if (threadIdx.x >= WARP) {
      attribute_lane<1>(c_ring + t, stage, params, rec_f, rec_x, period, b,
                        bp, T, tiles, B, acc_out, rec_out);
      return;
    }
""")],
    "diagnostic-hand-off-only": [(STEP_CALL,
                                  "      acc[0] = acc[0] + r.x;\n")],
    "diagnostic-hand-off-plus-adds-unrolled": [(STEP_LOOP, UNROLLED),
                                               (STEP_CALL, ADDS % "")],
    "diagnostic-hand-off-plus-adds-rolled": [(STEP_CALL, ADDS % "1")],
    "diagnostic-consumers-unrolled": [(STEP_LOOP, UNROLLED)],
})
K16 = [("constexpr int K = 8,", "constexpr int K = 16,")]


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
                if "Used" in ln or "bytes stack" in ln]
        print(f"build {name}: {' | '.join(regs)}")
        libs[name] = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        libs[name].engine_steps_launch.argtypes = [p] * 7 + [i, p]
        libs[name].engine_steps_collect_launch.argtypes = [p] * 10 + [i, p]
    return libs


def sass_functions(build_mod, lib: Path) -> dict[str, list[str]]:
    """``lib``'s SASS (``cuobjdump``), written beside it (``.sass``): each
    function's mangled name -> its instruction lines (address, opcode and
    operands), or ``{}`` where ``cuobjdump`` fails."""
    run = subprocess.run([str(Path(build_mod.nvcc()).with_name("cuobjdump")),
                          "-sass", str(lib)], capture_output=True, text=True)
    if run.returncode != 0:
        return {}
    lib.with_suffix(".sass").write_text(run.stdout)
    out, name = {}, None
    for ln in run.stdout.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[-1].strip()
            out[name] = []
        elif name is not None:
            # an instruction line starts with its address, /*0a40*/; the
            # line after it holds the rest of its encoding, /* 0x... */
            tok = ln.split()
            if len(tok) >= 2 and re.fullmatch(r"/\*[0-9a-f]+\*/", tok[0]):
                out[name].append(ln)
    return out


def opcodes(lines: list[str]) -> collections.Counter:
    ops = collections.Counter()
    for ln in lines:
        tok = ln.split()
        op = tok[2] if tok[1].startswith("@") else tok[1]
        ops[op.split(".")[0].rstrip(";")] += 1
    return ops


def function(funcs: dict, entry: str) -> list[str]:
    """The instruction lines of the function whose mangled name holds
    ``entry`` (length-prefixed, e.g. ``18engine_scan_kernelILb1E``: the
    anonymous namespace's tag carries the file name, which may hold the
    same words)."""
    hits = [v for k, v in funcs.items() if entry in k]
    return hits[0] if len(hits) == 1 else []


def sass_opcodes(build_mod, lib: Path, entry: str = "ILb0E") -> str:
    """Opcode counts of the scan kernel (not the pre-pass) in ``lib``, the
    instantiation whose mangled name holds ``entry`` (``ILb0E`` the default
    build, ``ILb1E`` the collect build)."""
    funcs = sass_functions(build_mod, lib)
    if not funcs:
        return "not counted: cuobjdump failed"
    ops = opcodes(function(funcs, f"18engine_scan_kernel{entry}"))
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


def collect_variants(torch, _build, engine_scan, inp, clock_hz,
                     baseline: Path | None) -> int:
    """The collect build's designs on the study's 168 lanes (--collect):
    the committed kernel (two warps, the attribution on the consumer warp),
    the post-pass, ``baseline``'s collect build where given (an older
    tree's ``engine_scan.cu``: its own design on the same entry point), and
    the producer alone; each timed in turns beside the default kernel, with
    its SASS instructions a step: each design also built with 16 records a
    tile, and the difference of its kernels' instructions over the 8 more
    steps unrolled."""
    texts = sources((_build.CSRC / "engine_scan.cu").read_text(),
                    COLLECT_VARIANTS)
    if baseline is not None:
        texts["baseline"] = baseline.read_text()
    texts.update({f"{name}-k16": sources(t, {"k16": K16})["k16"]
                  for name, t in list(texts.items())})
    libs = build(_build, texts)
    out_dir = ROOT / "build" / "variants"
    xi, xf, params, consts, period, n, ck = inp.args()
    recs = engine_scan.prepass(xi, xf, params, consts, collect=True)
    B, T = xf.shape[1], int(n.max())
    names = [k for k in texts if not k.endswith("-k16")]
    z = lambda *shape: torch.zeros(*shape, device="cuda")
    outs = {name: (z(8, B), z(23, B), z(T, B, 4)) for name in names}
    words = z(T, B, 4)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["post-pass"].engine_postpass_launch.argtypes = [p] * 7 + [i, p]

    def call(name):
        out, acc, rec = outs[name]
        dst = words if name == "post-pass" else rec
        code = libs[name].engine_steps_collect_launch(
            *(r.data_ptr() for r in recs), params.data_ptr(),
            period.data_ptr(), n.data_ptr(), ck.data_ptr(), out.data_ptr(),
            acc.data_ptr(), dst.data_ptr(), B, stream())
        if not code and name == "post-pass":
            code = libs[name].engine_postpass_launch(
                words.data_ptr(), recs[0].data_ptr(), recs[2].data_ptr(),
                period.data_ptr(), n.data_ptr(), acc.data_ptr(),
                rec.data_ptr(), B, stream())
        if code:
            raise SystemExit(f"{name}: launch failed, CUDA error {code}")

    calls = {name: (lambda name=name: call(name)) for name in names}
    calls["default kernel"] = lambda: engine_scan.steps(
        *recs[:2], params, period, n, ck)
    ms = time_in_turns(torch, calls)
    want = outs["kernel"]
    bits = lambda t: t.view(torch.int32)

    def per_step(name: str) -> str:
        """SASS instructions a step of the design's kernels."""
        lib = "kernel" if name == "default kernel" else name
        f8 = sass_functions(_build, out_dir / f"engine_scan-{lib}.so")
        f16 = sass_functions(_build, out_dir / f"engine_scan-{lib}-k16.so")
        if not f8 or not f16:
            return "SASS not counted (cuobjdump failed)"
        entry = ("18engine_scan_kernelILb0E" if name == "default kernel"
                 else "18engine_scan_kernelILb1E")
        n8 = len(function(f8, entry))
        n16 = len(function(f16, entry))
        text = (f"scan kernel {n8} instructions at 8 records a tile, {n16} at "
                f"16: {(n16 - n8) / 8:.1f} a step")
        post8 = function(f8, "22engine_postpass_kernel")
        post16 = function(f16, "22engine_postpass_kernel")
        if post8 and post16:
            text += (f"; post-pass kernel {len(post8)} / {len(post16)}: "
                     f"{(len(post16) - len(post8)) / 8:.1f} a step")
        return text

    for name in calls:
        same = ""
        if name in outs:
            got = outs[name]
            checked = [0] if "diagnostic" in name else [0, 1, 2]
            if not all(torch.equal(bits(got[i]), bits(want[i]))
                       for i in checked):
                raise SystemExit(f"{name}: differs from the kernel")
            same = (", bit for bit equal to the kernel" if len(checked) == 3
                    else ", timing outputs equal to the kernel's")
        print(f"{name}: {ms[name]:.4f} ms, "
              f"{ms[name] * 1e-3 * clock_hz / T:.1f} cycles a step at "
              f"{clock_hz / 1e6:.0f} MHz{same}; {per_step(name)}")
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
        base = [a.split("=", 1)[1] for a in sys.argv[1:]
                if a.startswith("--baseline=")]
        return collect_variants(torch, _build, engine_scan, inp, clock_hz,
                                Path(base[0]) if base else None)
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
