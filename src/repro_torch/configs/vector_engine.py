"""The paper's Table-10 evaluation environment: 24 vector-engine configs.

Configs 1-24: MVL in {8,16,32,64,128,256} 64-bit elements x lanes in {1,2,4,8},
renaming with 40 physical registers, in-order issue queues, one pipelined
arithmetic unit per lane, one memory port into L2, ring interconnect — the
§5 sweep.  ``TABLE10[i]`` is config i+1.  ``TABLE10_L2_1MB`` is the Fig-10
LLC grid and ``TABLE10_MSHR1`` the MSHR saturation grid; they run through
the same scan as the base grid.

Beyond the fixed grids, the design-space exploration spaces
(``SPACE_SMOKE`` / ``SPACE_QUICK`` / ``SPACE_FULL``) declare the live knob
ranges ``repro_torch.core.dse`` enumerates and reduces to Pareto
frontiers, and ``SPACE_10K`` / ``SPACE_HUGE`` the surrogate-search spaces.
Every axis is an engine parameter of the scan, so a whole space is one
scan launch.  Spaces, axes and their order are the reference's, so the
enumeration order, the labels and the cache keys are too.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dse import DesignSpace
from repro_torch.core.engine import VectorEngineConfig

MVLS = (8, 16, 32, 64, 128, 256)
LANES = (1, 2, 4, 8)

# The RVV-assembly-sourced suite variant: the seven RiVec apps plus the
# three ML apps with loop bodies decoded from ``src/repro_torch/asm``; the
# ":asm" names resolve through tracegen.body_for / chunks_for.
from repro_torch.core.tracegen import ASM_APPS as ASM_SUITE  # noqa: E402

TABLE10 = tuple(
    VectorEngineConfig(
        mvl=mvl, lanes=lanes, phys_regs=40, queue_entries=16,
        ooo_issue=False, vrf_read_ports=1, vrf_line_bits=512,
        interconnect="ring", mem_ports=1, cache_line_bits=512,
        lat_l1=4.0, lat_l2=12.0, l2_kb=256,
        scalar_freq_ghz=2.0, vector_freq_ghz=1.0, issue_width=2,
    )
    for mvl in MVLS for lanes in LANES
)

# §5.7's second memory system: 1 MB LLC (Fig 10)
TABLE10_L2_1MB = tuple(
    dataclasses.replace(cfg, l2_kb=1024) for cfg in TABLE10
)

# MSHR saturation study: a single miss-status register serializes every
# demand (indexed/gather) miss
TABLE10_MSHR1 = tuple(
    dataclasses.replace(cfg, mshrs=1) for cfg in TABLE10
)

# ---------------------------------------------------------------------------
# DSE spaces (repro_torch.core.dse): embedded short-vector -> HPC long-vector.
#
# SPACE_FULL is the headline design space — the Table-10 grid crossed with
# renaming depth, issue-queue size, issue policy, LLC capacity, MSHR file
# and DRAM bandwidth: 6*4*2*2*2*2*2*2 = 1536 configurations.  SPACE_QUICK
# (384) is the quick sweep (`python -m repro_torch.study --dse --quick`);
# SPACE_SMOKE (64) is the cache/dedup gate.
# ---------------------------------------------------------------------------

SPACE_FULL = DesignSpace.of(
    "full",
    mvl=MVLS,                        # 6
    lanes=LANES,                     # 4
    phys_regs=(40, 64),              # 2  renaming depth
    queue_entries=(8, 16),           # 2  issue-queue size
    ooo_issue=(False, True),         # 2  issue policy
    l2_kb=(256, 1024),               # 2  Fig-10 LLC axis
    mshrs=(1, 16),                   # 2  gather-miss concurrency
    dram_bw_bytes_cycle=(4.0, 8.0),  # 2  memory-system generation
)

SPACE_QUICK = DesignSpace.of(
    "quick",
    mvl=MVLS,                        # 6
    lanes=LANES,                     # 4
    ooo_issue=(False, True),         # 2
    l2_kb=(256, 1024),               # 2
    mshrs=(1, 16),                   # 2
    dram_bw_bytes_cycle=(4.0, 8.0),  # 2  -> 384 points
)

SPACE_SMOKE = DesignSpace.of(
    "smoke",
    mvl=(16, 64, 128, 256),
    lanes=(2, 8),
    l2_kb=(256, 1024),
    mshrs=(1, 16),
    dram_bw_bytes_cycle=(4.0, 8.0),
)

# ---------------------------------------------------------------------------
# Surrogate-search spaces: beyond exhaustive reach.  SPACE_HUGE widens every
# SPACE_FULL axis and opens the knobs the exact sweeps leave at their
# defaults: 6*5*4*2*3*2*2*2*2*3*4*3*3 = 1,244,160 configurations, every
# SPACE_FULL point among them.  SPACE_10K (18,432) is the small search space.
# ---------------------------------------------------------------------------

SPACE_HUGE = DesignSpace.of(
    "huge",
    mvl=MVLS,                             # 6
    lanes=(1, 2, 4, 8, 16),               # 5  datapath width, past Table 10
    phys_regs=(40, 48, 64, 96),           # 4  renaming depth (96 = ring cap)
    rob_entries=(32, 64),                 # 2  reorder window
    queue_entries=(8, 16, 32),            # 3  issue-queue size
    ooo_issue=(False, True),              # 2  issue policy
    vrf_read_ports=(1, 2),                # 2  VRF port count (§3.2.4 startup)
    interconnect=("ring", "crossbar"),    # 2  slide/reduce topology (§3.2.6)
    mem_ports=(1, 2),                     # 2  L2 ports
    l1_kb=(16, 32, 64),                   # 3  private cache
    l2_kb=(256, 512, 1024, 2048),         # 4  LLC capacity
    mshrs=(1, 4, 16),                     # 3  gather-miss concurrency
    dram_bw_bytes_cycle=(4.0, 8.0, 16.0),  # 3  memory-system generation
)

SPACE_10K = DesignSpace.of(
    "10k",
    mvl=MVLS,                        # 6
    lanes=LANES,                     # 4
    phys_regs=(40, 64),              # 2
    rob_entries=(32, 64),            # 2
    queue_entries=(8, 16),           # 2
    ooo_issue=(False, True),         # 2
    vrf_read_ports=(1, 2),           # 2
    l1_kb=(16, 32, 64),              # 3
    l2_kb=(256, 1024),               # 2
    mshrs=(1, 16),                   # 2
    dram_bw_bytes_cycle=(4.0, 8.0),  # 2  -> 18,432 points
)

# Default app subsets per space: smoke pairs a compute-bound app with the
# gather-heavy one (both memory paths), quick adds a frontend-lowered ML
# workload, full is the whole 10-app suite.
SPACE_PRESET_APPS = {
    "smoke": ("blackscholes", "canneal"),
    "quick": ("blackscholes", "canneal", "ssd_scan"),
    "full": None,  # explore() default: every registered app
}
