"""The attention backward kernel and the segment-sum kernel on the card.

Builds ``flash_attention``, ``flash_attention_bwd`` and ``segment_sum``
(printing each kernel's ptxas line), then:

- holds the backward kernel's dq, dk, dv against the plain version
  (``ref.flash_attention_bwd``) on the same inputs over D 16, 32, 64, 72,
  100, 128, float32 / bfloat16 / float16, S 48, 200, 1,000, causal or not:
  the worst difference over the grid as a share of each gradient's largest
  magnitude, and two calls bit for bit;
- checks the forward's ``lse`` output: the output bits equal to the call
  without it, lse against ``ref.flash_attention_lse``;
- times, at qwen2.5-3b's training shape (B 2, S 4,096, H 16, D 128 bf16,
  causal), the forward with and without lse, the backward kernel (a call,
  and its kernels apart under ``torch.profiler``: the statistics pre-pass,
  the main kernel, the dQ post-pass, the counters' memset), SDPA's forward
  and forward + backward, beside the bound (10 D flops a kept pair at 989
  TFLOP/s); three calls at B 4 (far more blocks than SMs) bit for bit;
- holds the segment sum (8,192 Zipf tokens x 2,048, bf16 in, float32 and
  bf16 out, 151,936 rows) against float64 sums and bit for bit against
  ``segment_sum_chunked`` (the kernel's order in plain torch), twice bit
  for bit, timed beside ``index_add_``, its call's pieces apart under
  ``torch.profiler`` (the sort, the chunk pass, the write pass), and a
  stable sort of int32 keys against one of int64 keys.

Run on a machine with the card, from the repository root:
``python3 scripts/flash_attention_bwd_check.py`` (~1 min with the builds;
``--segment`` the segment sum alone).
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, kernel_split, split_ms  # noqa: E402

PEAK_BF16_S = 989e12


def grid_errors(torch, fa, fab, ref, dev):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in (16, 32, 64, 72, 100, 128):
            for S in (48, 200, 1000):
                for causal in (True, False):
                    g = torch.Generator(device=dev).manual_seed(D + S)
                    q, k, v, dout = (torch.randn(2, S, 3, D, generator=g,
                                                 device=dev).to(dtype)
                                     for _ in range(4))
                    out, lse = fa.flash_attention_lse(q, k, v, causal)
                    same_out = torch.equal(out, fa.flash_attention(
                        q, k, v, causal))
                    lse_want = ref.flash_attention_lse(q, k, v, causal)[1]
                    lse_err = float((lse - lse_want).abs().max())
                    got = fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  causal)
                    again = fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    causal)
                    want = ref.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   causal)
                    torch.cuda.synchronize()
                    errs = [float((a.double() - b.double()).abs().max()
                                  / b.double().abs().max().clamp_min(1e-30))
                            for a, b in zip(got, want)]
                    bitwise = all(torch.equal(a, b)
                                  for a, b in zip(got, again))
                    key = str(dtype).split(".")[-1]
                    w = worst.setdefault(key, dict(err=0.0, at=None,
                                                   lse=0.0, bitwise=True,
                                                   same_out=True))
                    if max(errs) > w["err"]:
                        w["err"], w["at"] = max(errs), (D, S, causal,
                                                        [round(e, 7)
                                                         for e in errs])
                    w["lse"] = max(w["lse"], lse_err)
                    w["bitwise"] &= bitwise
                    w["same_out"] &= same_out
    for key, w in worst.items():
        print(f"backward grid {key}: worst gradient error {w['err']:.4g} of "
              f"its largest magnitude at (D, S, causal, [dq, dk, dv]) "
              f"{w['at']}; lse max abs err {w['lse']:.3g}; two calls bit "
              f"for bit {w['bitwise']}; forward output with lse equal to "
              f"without {w['same_out']}")
    return worst


def timed(fn):
    """Median device ms of a call of ``fn`` (``chip_smoke.cuda_ms``)."""
    import torch
    return cuda_ms(torch, fn, reps=10)


def training_shape(torch, fa, fab, ref, dev):
    B, S, H, D = 2, 4096, 16, 128
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_lse(q, k, v, True)
    got = fab.flash_attention_bwd(q, k, v, out, lse, dout, True)
    want = ref.flash_attention_bwd(*(t.float() for t in (q, k, v, out)), lse,
                                   dout.float(), True)
    errs = [float((a.double() - b.double()).abs().max()
                  / b.double().abs().max()) for a, b in zip(got, want)]
    del want
    fwd = timed(lambda: fa.flash_attention(q, k, v, True))
    fwd_lse = timed(lambda: fa.flash_attention_lse(q, k, v, True))
    bwd = timed(lambda: fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                                True))
    split = kernel_split(torch, lambda: fab.flash_attention_bwd(
        q, k, v, out, lse, dout, True))
    parts = {name: split_ms(split, name) for name in
             ("stats_kernel", "bwd_h16_kernel", "dq_post_kernel")}
    parts["memset"] = split_ms(split, "emset")
    print(f"backward kernels apart (profiler, ms a call): {parts}; all "
          f"{sum(split.values()):.4f}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dt_ = dout.transpose(1, 2)
    sdpa_f = timed(lambda: sdpa(qt, kt, vt, is_causal=True))

    def sdpa_fb():
        o = sdpa(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(o, (qt, kt, vt), dt_)

    sdpa_fb_ms = timed(sdpa_fb)
    pairs = B * H * S * (S + 1) // 2
    bound = 10 * D * pairs / PEAK_BF16_S * 1e3
    print(f"training shape (B {B}, S {S}, H {H}, D {D}, bf16, causal): "
          f"forward {fwd:.4f} ms, with lse {fwd_lse:.4f} ms; backward kernel "
          f"{bwd:.4f} ms ({10 * D * pairs / bwd / 1e9:.1f} TFLOP/s of the "
          f"10 D it does); SDPA forward {sdpa_f:.4f}, forward + backward "
          f"{sdpa_fb_ms:.4f}, backward alone {sdpa_fb_ms - sdpa_f:.4f} ms; "
          f"bound {bound:.4f} ms (10 D a kept pair); gradient errors "
          f"against the float32 plain backward on the same bf16 inputs "
          f"(dq, dk, dv, share of the largest magnitude) "
          f"{[round(e, 6) for e in errs]}")
    del q, k, v, dout, out, lse
    # three calls at B 4: 2,048 blocks on 132 SMs, the counters' order
    # exercised
    same = {}
    for causal in (True, False):
        q, k, v, dout = (torch.randn(4, S, H, D, generator=g, device=dev)
                         .to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention_lse(q, k, v, causal)
        first = fab.flash_attention_bwd(q, k, v, out, lse, dout, causal)
        same[causal] = all(
            all(torch.equal(a, b) for a, b in zip(
                first, fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                               causal)))
            for _ in range(2))
        del q, k, v, dout, out, lse, first
    print(f"B 4 x S {S} x H {H} x D {D} bf16: three calls bit for bit "
          f"(causal, full) {same[True]}, {same[False]}")
    return dict(fwd=fwd, fwd_lse=fwd_lse, bwd=bwd, sdpa_fwd=sdpa_f,
                sdpa_fb=sdpa_fb_ms, bound=bound, errs=errs, parts=parts,
                b4_bitwise=same)


def segment_check(torch, ss, dev):
    import numpy as np
    N, D, V = 8192, 2048, 151_936
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(np.minimum(rng.zipf(1.1, N) - 1, V - 1)).to(dev)
    rows = torch.randn(N, D, device=dev).to(torch.bfloat16)
    got32 = ss.segment_sum(rows, tok, V, torch.float32)
    again = ss.segment_sum(rows, tok, V, torch.float32)
    f64 = torch.zeros(V, D, dtype=torch.float64, device=dev).index_add_(
        0, tok, rows.double())
    err = float((got32.double() - f64).abs().max())
    n_max = int(tok.bincount().max())
    got16 = ss.segment_sum(rows, tok, V)
    ms = timed(lambda: ss.segment_sum(rows, tok, V))
    r32 = rows.float()
    out = torch.zeros(V, D, device=dev)
    lib = timed(lambda: out.zero_().index_add_(0, tok, r32))
    bound = (N * D * 2 + V * D * 2) / 3.35e12 * 1e3
    chunked = ss.segment_sum_chunked(rows, tok, V, torch.float32)
    split = kernel_split(torch, lambda: ss.segment_sum(rows, tok, V))
    pieces = dict(chunk_pass=split_ms(split, "chunk_kernel"),
                  write_pass=split_ms(split, "write_kernel"))
    pieces["sort"] = sum(split.values()) - sum(pieces.values())
    sort32 = timed(lambda: torch.sort(tok.to(torch.int32), stable=True))
    sort64 = timed(lambda: torch.sort(tok.long(), stable=True))
    print(f"segment sum pieces (profiler, ms a call): {pieces}; a stable "
          f"sort of the indices as int32 keys (with the cast) {sort32:.4f} "
          f"ms, as int64 keys {sort64:.4f} ms")
    print(f"segment sum ({N} Zipf tokens, the most frequent {n_max} times, "
          f"x {D}, bf16 in; {V} rows): float32 out max abs err {err:.3g} "
          f"against float64; equal to segment_sum_chunked "
          f"{torch.equal(got32, chunked)}; two calls bit for bit "
          f"{torch.equal(got32, again)}; bf16 out equal to the float32 sum "
          f"rounded {torch.equal(got16, got32.to(torch.bfloat16))}; call "
          f"{ms:.4f} ms, index_add_ (float32) {lib:.4f} ms, bound "
          f"{bound:.4f} ms (bytes)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as ss
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    report = _build.build_all(("flash_attention", "flash_attention_bwd",
                               "segment_sum"))
    for name, r in report.items():
        entries = re.findall(r"Compiling entry function '(\w+)'", r["log"])
        usage = re.findall(r"(\d+ bytes stack frame, \d+ bytes spill stores,"
                           r" \d+ bytes spill loads)\s*\n\s*ptxas info\s*: "
                           r"Used (\d+) registers", r["log"])
        print(f"build {name}: {r['seconds']:.1f} s")
        for e, (spill, regs) in zip(entries, usage):
            print(f"  {e}: {regs} registers; {spill}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] == ["--segment"]:
        segment_check(torch, ss, dev)
        return 0
    worst = grid_errors(torch, fa, fab, ref, dev)
    train = training_shape(torch, fa, fab, ref, dev)
    segment_check(torch, ss, dev)
    print(json.dumps({"grid": worst, "train": train}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
