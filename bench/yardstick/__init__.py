"""The benchmark's yardstick: everything a run measures with.

Traffic generation (``traffic``, ``tokens``), the weights drawn from the
seed (``weights``), the timers and the reading of the profiler's trace
(``timer``), the H100 peaks (``peaks``) and the FLOP and byte counts
(``counts``), the comparison that decides ``correct`` (``checks``), and one
runner for each kind of traffic (``kinds``).  The program under test,
``repro_torch``, is imported only by the runners, through its entry points.
"""
