"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port) on one
H100: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the port is imported from ``src/``, its
kernels are built into ``build/`` there (``repro_torch._build``), and the
cells, configurations, traffic mixes, metrics and limits are read from
``BENCHMARK.json`` and ``bench/``.  See ``bench/yardstick/main.py``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's bytecode of every module the run imports (torch's ~2,000 among
# them) is kept at a fixed path inside the checkout: where the installed
# packages carry none and the environment forbids writing it, each run
# would compile them all from source again (about 7 s of set-up on the
# card's host, paced by its shared cores), and only a checkout's first run
# does.
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT / "bench"))
sys.path.insert(0, str(ROOT / "src"))

from yardstick.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START, root=ROOT))
