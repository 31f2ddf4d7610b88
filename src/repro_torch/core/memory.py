"""Analytic memory-hierarchy model: caches, MSHRs, DRAM bandwidth (§3.2.5).

The port of ``repro/core/memory.py:61-165`` as torch functions on float32
tensors.  Every expression keeps the reference's operand order, so each
rounding happens where the reference's does and the results agree bitwise;
the CUDA scan (``csrc/engine_scan.cu``) inlines the same expressions.

Every vector memory access derives its L1/L2 miss probabilities from its
stream **footprint** (KB), its **access pattern** and the **cache geometry**:
a stream of footprint ``F`` re-traversed through a cache of capacity ``C``
keeps ``min(1, C/F)`` of its lines resident.  Service time is a lead-in
(the exposed latency of the first misses) plus a per-access throughput term,
the max of the port rate, the MSHR-limited L2/DRAM rates and the shared DRAM
bandwidth.  Indexed gathers overlap ``min(mshrs, DRAM_MLP)`` misses; regular
streams ride a ``PREFETCH_DEPTH``-line run-ahead window.

>>> import torch
>>> f32 = lambda v: torch.tensor(v, dtype=torch.float32)
>>> m1, m2 = miss_probs(f32(13824.0), f32(32.0), f32(256.0))
>>> round(float(m1), 3), round(float(m2), 3)
(0.998, 0.984)
>>> float(cycles_per_access(f32(1.0), f32(1.0), f32(12.0), f32(100.0),
...                         f32(1.0), f32(16.0), f32(1.0)))
100.0
"""
from __future__ import annotations

import torch

from repro_torch.core import isa

# Effective DRAM stream bandwidth, bytes per vector-engine cycle (1 GHz):
# DDR3-class sustained bandwidth; a 512-bit line costs 16 cycles.
DRAM_BW_BYTES_PER_CYCLE = 4.0

# Bank-level parallelism cap on overlapping demand misses.
DRAM_MLP = 8.0

# Run-ahead depth (lines) of the decoupled VMU's stream prefetcher.
PREFETCH_DEPTH = 16.0


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def residency(footprint_kb, cache_kb):
    """Steady-state fraction of a stream's lines resident in a cache."""
    return torch.clamp_max(
        cache_kb / torch.clamp_min(footprint_kb, _f32(1e-6, footprint_kb)),
        1.0)


def miss_probs(footprint_kb, l1_kb, l2_kb):
    """Per-line (m1, m2): P(L1 miss) and P(L2 miss | L1 miss), inclusive."""
    r1 = residency(footprint_kb, l1_kb)
    r2 = residency(footprint_kb, l2_kb)
    m1 = 1.0 - r1
    m2 = torch.clamp((1.0 - r2) / torch.clamp_min(m1, _f32(1e-6, m1)),
                     0.0, 1.0)
    return m1, m2


def overlap(pattern, mshrs):
    """Outstanding-miss concurrency of one vector memory access."""
    return torch.where(pattern == isa.MEM_INDEXED,
                       torch.clamp_max(mshrs, DRAM_MLP),
                       _f32(PREFETCH_DEPTH, mshrs))


def dram_line_cycles(cache_line_bits, bw_bytes_cycle=DRAM_BW_BYTES_PER_CYCLE):
    """Bandwidth cost of moving one cache line from DRAM (cycles); host
    float64 arithmetic, cast to float32 by the engine's parameter vector.

    >>> dram_line_cycles(512.0)
    16.0
    """
    return cache_line_bits / 8.0 / bw_bytes_cycle


def lead_cycles(m1, m2, lat_l1, lat_l2, lat_dram, ovl):
    """Exposed lead-in latency of a vector memory instruction."""
    return lat_l1 + (m1 * lat_l2 + m1 * m2 * lat_dram) / ovl


def cycles_per_access(m1, m2, lat_l2, lat_dram, ovl, line_cyc, mem_ports):
    """Steady-state throughput cost of one access."""
    port = torch.ones_like(mem_ports) / mem_ports
    l2 = m1 * lat_l2 / ovl
    dram = m1 * m2 * torch.maximum(lat_dram / ovl, line_cyc)
    return torch.maximum(port, torch.maximum(l2, dram))


def vector_access_cycles(vlf, pattern, footprint_kb, line_elems, l1_kb, l2_kb,
                         mshrs, lat_l1, lat_l2, lat_dram, line_cyc, mem_ports):
    """Total VMU occupancy (cycles) of one vector memory instruction.

    Unit-stride accesses are line-granular (``ceil(vl / line_elems)``
    accesses); strided and indexed accesses touch one line per element.
    Arguments broadcast: per-record tensors against per-config ones.
    """
    m1, m2 = miss_probs(footprint_kb, l1_kb, l2_kb)
    ovl = overlap(pattern, mshrs)
    lead = lead_cycles(m1, m2, lat_l1, lat_l2, lat_dram, ovl)
    per = cycles_per_access(m1, m2, lat_l2, lat_dram, ovl, line_cyc, mem_ports)
    n_acc = torch.where(pattern == isa.MEM_UNIT,
                        torch.ceil(vlf / line_elems), vlf)
    return lead + n_acc * per
