"""Beyond-paper study: the knobs the paper lists but never evaluates (§7).

    python -m repro_torch.futurework_study [--quick] [--device cuda|cpu]

The port of ``benchmarks/futurework_study.py``.  The paper's §3 describes
out-of-order issue, a crossbar against the ring interconnect, VRF read
ports and memory ports, but §5 evaluates only the in-order, ring, one-port
design.  This study sweeps those knobs over the suite at MVL 64 x 4 lanes:
each variant's speedup relative to the evaluated baseline, per app, the
whole (variant x app) grid in one ``suite.speedup_batch`` call (one engine
scan launch).  The engine runs on the CUDA device unless ``--device cpu``
is given.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import engine as eng
from repro_torch.core import suite, tracegen

BASE = eng.VectorEngineConfig(mvl=64, lanes=4)

VARIANTS = {
    "baseline(in-order,ring,1rp,1mp)": {},
    "ooo_issue": {"ooo_issue": True},
    "crossbar": {"interconnect": "crossbar"},
    "vrf_3_read_ports": {"vrf_read_ports": 3},
    "2_mem_ports": {"mem_ports": 2},
    "all_upgrades": {"ooo_issue": True, "interconnect": "crossbar",
                     "vrf_read_ports": 3, "mem_ports": 2},
}


def study(apps=None, variants=None, device=None) -> dict:
    """Each variant's speedup relative to the evaluated baseline design,
    per app: ``{variant: {app: ratio}}``, from one batched launch."""
    apps = list(tracegen.APPS) if apps is None else list(apps)
    variants = dict(VARIANTS) if variants is None else dict(variants)
    pairs = [(app, dataclasses.replace(BASE, **kw))
             for kw in variants.values() for app in apps]
    flat = suite.speedup_batch(pairs, device=device)
    n = len(apps)
    rows = {name: dict(zip(apps, flat[i * n:(i + 1) * n]))
            for i, name in enumerate(variants)}
    # normalize to the named baseline wherever it sits in the dict
    base_name = next((k for k in variants if k.startswith("baseline")),
                     next(iter(variants)))
    base = rows[base_name]
    return {name: {a: s / base[a] for a, s in row.items()}
            for name, row in rows.items()}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.futurework_study",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="two apps x three variants (the driver's smoke)")
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    args = ap.parse_args(argv)
    apps = ["blackscholes", "jacobi-2d"] if args.quick else None
    variants = None
    if args.quick:
        variants = {k: VARIANTS[k] for k in
                    ("baseline(in-order,ring,1rp,1mp)", "ooo_issue",
                     "crossbar")}
    table = study(apps, variants, device=args.device)
    apps = list(next(iter(table.values())))
    print(f"{'variant':34s}" + "".join(f"{a[:10]:>11s}" for a in apps))
    for name, row in table.items():
        print(f"{name:34s}" + "".join(f"{row[a]:11.3f}" for a in apps))
    print("\n(values are speedup relative to the paper's evaluated design; "
          "MVL=64, 4 lanes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
