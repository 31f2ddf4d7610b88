"""The paper's §5 study: the RiVec suite on 24 vector-engine configurations.

    python -m repro_torch.vector_engine_study [--app NAME] [--device cuda|cpu]

The port of ``examples/vector_engine_study.py``: the shape of Figures 4-10
(speedup over scalar against MVL x lanes, per app) and the Fig-10 LLC
comparison, printed as tables.  Every app x the 24 configs runs in one
batched ``suite.sweep_all`` (one engine scan launch), the LLC study in one
``suite.speedup_batch``.  The engine runs on the CUDA device unless
``--device cpu`` is given.
"""
from __future__ import annotations

from repro_torch.core import engine as eng
from repro_torch.core import suite, tracegen
from repro_torch.core.characterize import characterize

MVLS = (8, 16, 32, 64, 128, 256)
LANES = (1, 2, 4, 8)


def study(app: str, grid: dict) -> None:
    """Print one app's 24-config table from a batched ``sweep_all``
    result."""
    print(f"\n=== {app} ({tracegen.APPS[app].notes}) ===")
    c = characterize(app, 8)
    print(f"VAO speedup {c.vao_speedup:.2f}; "
          f"%vectorization {c.pct_vectorization:.0%} @MVL=8")
    print("speedup over scalar     " + "".join(f"  L={l}  " for l in LANES))
    for m in MVLS:
        print(f"  MVL={m:4d}            "
              + "".join(f"{grid[(m, l)]:6.2f}" for l in LANES))


def llc_study(device=None) -> list[float]:
    """Swaptions at 8 lanes with a 256 KB and a 1 MB LLC (paper Fig 10)."""
    print("\n=== swaptions LLC study (paper Fig 10) ===")
    mvls = (8, 64, 128, 256)
    pairs = [("swaptions", eng.VectorEngineConfig(mvl=m, lanes=8, l2_kb=l2))
             for l2 in (256, 1024) for m in mvls]
    vals = suite.speedup_batch(pairs, device=device)
    for i, l2 in enumerate((256, 1024)):
        row = vals[i * len(mvls):(i + 1) * len(mvls)]
        print(f"  L2={l2:5d}KB  " + "".join(f"{s:6.2f}" for s in row))
    return vals


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.vector_engine_study",
        description=__doc__.splitlines()[0])
    ap.add_argument("--app", default=None)
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    args = ap.parse_args(argv)
    apps = [args.app] if args.app else list(tracegen.APPS)
    table = suite.sweep_all(apps, device=args.device)   # one batch
    for app in apps:
        study(app, table[app])
    llc_study(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
