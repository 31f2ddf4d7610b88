"""Frontend-only ML workloads: flash attention, decode attention, SSD scan.

The port of ``repro/core/workloads_ml.py``.  The three ML kernels
(``kernels/flash_attention.py``, ``decode_attention.py``, ``ssd_scan.py``)
each get a *chunk kernel spec* — the RVV-style vectorization of one
MVL-chunk of the kernel's inner loop, written in plain torch and lowered by
``core.frontend`` — so they take part in the 24-config batched sweep and
the golden regression exactly like the seven RiVec apps.  Each spec runs
its ops in the order of the reference's JAX spec, so the lowered traces
are the reference's, fingerprint for fingerprint.

Vectorization choices (the "how would this run on the paper's machine"
mapping, mirroring the Pallas kernels' math):

* **flash_attention** — one chunk = one query row against MVL keys (K/V
  pre-transposed so key-dim accesses are unit-stride).  Per chunk: the q·K
  dot chain, an online-softmax max/sum pair of reductions whose results the
  scalar core consumes (`dep_scalar`, the §4.1.4 round trip), and the p·V
  accumulation as per-dim multiply+reduce.  Reduction-heavy → stresses the
  lane interconnect; the per-head K/V block (512 KB) is the Fig-10-style
  LLC lever.
* **decode_attention** — one chunk = one (batch, head) against MVL cached
  keys, with the valid-length mask (iota-compare-select).  The KV cache is
  streamed with no reuse (multi-MB footprint) and V is strided → DRAM
  bandwidth bound, the memory-wall workload of the three.
* **ssd_scan** — one chunk = MVL timesteps of the Mamba-2 chunk scan: the
  `cumsum` decay prefix lowers to the RVV slide+add ladder
  (`ceil(log2(vl))` rounds), plus exp-heavy state weighting and a rank-1
  state reduction → slide/transcendental-heavy.

Counts models are *derived from the lowered trace* (per-chunk instruction
and element counts x a closed-form chunk count), with a scalar-version
overhead factor standing in for the paper's scalar-code measurements; these
workloads have no published tables, so ``docs/calibration.md`` marks them
modeled-not-paper-calibrated.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import frontend as fe
from repro_torch.core import isa

# ---------------------------------------------------------------- workload scales
_FA_B, _FA_H, _FA_S, _FA_D = 4, 8, 2048, 64
_FA_KV_KB = _FA_S * _FA_D * 4 / 1024          # one head's K (=V) block: 512 KB

_DA_B, _DA_H, _DA_S, _DA_D = 32, 8, 4096, 64
_DA_KV_KB = _DA_S * _DA_H * _DA_D * 4 / 1024  # streamed cache slice: 8 MB

_SSD_B, _SSD_S, _SSD_H = 8, 65536, 16
_SSD_SEQ_KB = _SSD_S * 4 / 1024               # one (b,h) sequence array: 256 KB

# scalar-version overhead factor: loop/addressing instructions per element
# op in the scalar code (the closed forms' s1-equivalent, modeled)
_FA_OVH, _DA_OVH, _SSD_OVH = 0.4, 0.4, 0.5


def _attention_spec(vl, D, kv_kb, v_pattern=isa.MEM_UNIT, masked=False):
    """Shared chunk spec of both attention kernels: q·K dot chain, online
    softmax with the vfred→scalar round trip, p·V per-dim accumulation.
    ``masked`` adds decode's valid-length (iota-compare-select) mask."""
    k_streams = tuple(fe.Stream(f"k{d}", kv_kb) for d in range(D))
    v_streams = tuple(fe.Stream(f"v{d}", kv_kb, pattern=v_pattern)
                      for d in range(D))

    def score(*kcols):
        s = kcols[0] * 0.125
        for d in range(1, D):
            s = s + kcols[d] * 0.125
        if masked:
            ki = torch.arange(vl)       # iota: immediate
            s = torch.where(ki < vl - 1, s, -1e30)
        m = torch.amax(s)               # online-softmax running max
        p = torch.exp(s - m)
        l = torch.sum(p)                # noqa: F841  (scalar core consumes it)
        return p

    def accum(p, *vcols):
        t = p
        for d in range(D):
            t = p * vcols[d]
            o_d = torch.sum(t)          # noqa: F841  per-dim output element
        return t

    return [
        fe.KernelBody(score, vl, ins=k_streams, outs=("p",), lazy_loads=True),
        # m/l running-statistics update on the scalar core, fed by the
        # reductions above (vfred -> scalar round trip)
        fe.ScalarWork(6, dep_scalar=True),
        fe.KernelBody(accum, vl, ins=("p",) + v_streams,
                      outs=(fe.Stream("o", kv_kb),), lazy_loads=True),
    ]


def _fa_kernel(mvl, cfg):
    vl = min(mvl, cfg.mvl) if cfg else mvl
    return _attention_spec(vl, _FA_D, _FA_KV_KB)


def _da_kernel(mvl, cfg):
    vl = min(mvl, cfg.mvl) if cfg else mvl
    return _attention_spec(vl, _DA_D, _DA_KV_KB,
                           v_pattern=isa.MEM_STRIDED, masked=True)


def _ssd_kernel(mvl, cfg):
    vl = min(mvl, cfg.mvl) if cfg else mvl
    ins = (fe.Stream("x", _SSD_SEQ_KB), fe.Stream("dt", _SSD_SEQ_KB),
           fe.Stream("B", _SSD_SEQ_KB), fe.Stream("C", _SSD_SEQ_KB))

    def fn(x, dt, b, c):
        dA = dt * -0.05
        seg = torch.cumsum(dA, 0)       # decay prefix: slide+add ladder
        g = torch.exp(seg)
        gi = torch.exp(-seg)
        xd = x * dt
        w = b * xd
        w = w * gi
        snew = torch.sum(w)             # rank-1 state update
        y = c * g
        y = y * snew
        return y + xd * 0.5             # D-skip path

    return [fe.KernelBody(fn, vl, ins=ins,
                          outs=(fe.Stream("y", _SSD_SEQ_KB),))]


_SPECS = {
    "flash_attention": (_fa_kernel,
                        lambda mvl: _FA_B * _FA_H * _FA_S * (_FA_S / 2) / mvl,
                        _FA_OVH),
    "decode_attention": (_da_kernel,
                         lambda mvl: _DA_B * _DA_H * _DA_S / mvl,
                         _DA_OVH),
    "ssd_scan": (_ssd_kernel,
                 lambda mvl: _SSD_B * _SSD_H * _SSD_S / mvl,
                 _SSD_OVH),
}

NOTES = {
    "flash_attention": "reduction/scalar-comm heavy; LLC-sensitive KV block",
    "decode_attention": "DRAM-bandwidth bound; strided V; streamed KV cache",
    "ssd_scan": "cumsum slide ladder + transcendental decay; Mamba-2 SSD",
}

_TRACE_CACHE: dict = {}


def _chunk_trace(name: str, vl: int) -> isa.Trace:
    """The lowered chunk at vector length ``vl`` (cached: a spec depends on
    ``(mvl, cfg)`` only through ``vl = min(mvl, cfg.mvl)``)."""
    key = (name, vl)
    out = _TRACE_CACHE.get(key)
    if out is None:
        out = _TRACE_CACHE[key] = fe.lower_trace(_SPECS[name][0](vl, None))
    return out


def _body(name: str, mvl: int, cfg) -> isa.Trace:
    return _chunk_trace(name, min(mvl, cfg.mvl) if cfg else mvl)


class _LazyMix(dict):
    """App.mix derived from the lowered chunk trace, materialized on first
    access — keeps `import repro_torch.core.tracegen` free of tracing."""

    def __init__(self, name):
        super().__init__()
        self._name = name
        self._filled = False

    def _fill(self):
        if not self._filled:
            self._filled = True
            self.update(fe.trace_mix(_chunk_trace(self._name, 64)))

    def __getitem__(self, k):
        self._fill()
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._fill()
        return super().get(k, default)

    def items(self):
        self._fill()
        return super().items()

    def values(self):
        self._fill()
        return super().values()

    def keys(self):
        self._fill()
        return super().keys()


def make_apps(App, Counts) -> dict:
    """Build the three App entries (App/Counts passed in by tracegen to keep
    the import acyclic).  Counts are derived from the lowered chunk trace:
    per-chunk instruction/element totals x the closed-form chunk count."""
    apps = {}
    for name, (kernel, chunks_fn, ovh) in _SPECS.items():
        def counts_fn(mvl, name=name, chunks_fn=chunks_fn, ovh=ovh):
            tr = _chunk_trace(name, mvl)
            ch = chunks_fn(mvl)
            k = tr.kind
            vec = (k != isa.SCALAR_BLOCK) & (k != isa.NOP)
            mem = float(np.sum((k == isa.VLOAD) | (k == isa.VSTORE)))
            arith = float(np.sum((k == isa.VARITH) | (k == isa.VMOVE)))
            manip = float(np.sum(np.isin(
                k, (isa.VSLIDE, isa.VREDUCE, isa.VMASK_SCALAR))))
            ops = float(tr.vl[vec].sum()) * ch
            scalar = float(tr.scalar_count.sum()) * ch + 1e6
            return Counts(
                scalar_code_total=ops * (1.0 + ovh) + scalar,
                scalar_instrs=scalar,
                vector_mem=mem * ch, vector_arith=arith * ch,
                vector_manip=manip * ch, vector_ops=ops)

        apps[name] = App(
            name,
            counts_fn,
            lambda mvl, cfg, name=name: _body(name, mvl, cfg),
            chunks_fn,
            _LazyMix(name),
            kernel=kernel,
            asm=f"{name}.s",
            notes=NOTES[name])
    return apps
