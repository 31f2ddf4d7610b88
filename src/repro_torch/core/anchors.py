"""The paper's §5 speedup anchors — the repo-wide accuracy contract.

Eleven published (app, MVL, lanes) -> speedup points read off Figures 4-9.
``"eq"`` anchors are numeric targets (model/paper inside the
[``EQ_LO``, ``EQ_HI``] band, the tolerance the whole repo documents);
``"lt"`` anchors encode the paper's qualitative claims — canneal degrades
below scalar at MVL>=128 (§5.2) and no particlefilter configuration beats
the scalar core (§5.4) — as hard upper bounds.

The port's copy of ``repro/core/anchors.py``: ``tests/test_torch_suite.py``
and ``chip_smoke.py`` hold the port's speedups to the same bands.
"""
from __future__ import annotations

# (app, mvl, lanes, paper speedup, kind)
ANCHORS = (
    ("blackscholes", 8, 1, 2.22, "eq"),
    ("jacobi-2d", 8, 1, 1.79, "eq"),
    ("jacobi-2d", 256, 1, 2.99, "eq"),
    ("canneal", 16, 1, 1.64, "eq"),
    ("canneal", 16, 8, 1.88, "eq"),
    ("canneal", 256, 1, 1.0, "lt"),
    ("particlefilter", 8, 1, 1.0, "lt"),
    ("particlefilter", 256, 8, 1.0, "lt"),
    ("pathfinder", 8, 1, 1.8, "eq"),
    ("streamcluster", 8, 1, 1.68, "eq"),
    ("swaptions", 8, 1, 1.03, "eq"),
)

# documented tolerance band for "eq" anchors: EQ_LO <= model/paper <= EQ_HI
EQ_LO, EQ_HI = 0.80, 1.25
# "lt" anchors are hard qualitative bounds: model <= target * LT_SLACK
LT_SLACK = 1.0
