"""The paper's Table-10 evaluation environment: 24 vector-engine configs.

Configs 1-24: MVL in {8,16,32,64,128,256} 64-bit elements x lanes in {1,2,4,8},
renaming with 40 physical registers, in-order issue queues, one pipelined
arithmetic unit per lane, one memory port into L2, ring interconnect — the
§5 sweep.  ``TABLE10[i]`` is config i+1.  ``TABLE10_L2_1MB`` is the Fig-10
LLC grid and ``TABLE10_MSHR1`` the MSHR saturation grid; they run through
the same scan as the base grid.  (The reference's DSE spaces come with the
DSE slice.)
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.engine import VectorEngineConfig

MVLS = (8, 16, 32, 64, 128, 256)
LANES = (1, 2, 4, 8)

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
