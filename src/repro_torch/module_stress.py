"""Which engine modules each app stresses, derived two independent ways.

    python -m repro_torch.module_stress [--device cuda|cpu]

The port of ``benchmarks/module_stress.py``: it validates the paper's
Table 2 two ways and cross-checks them for all ten apps.

**Differential**: static trace shares and knob ablation — the
manipulation and indexed instruction shares, the lane / VMU busy fractions
from the default engine metrics, and the ``mshrs=1`` slowdown (one
``simulate_batch`` launch for all apps at both configs).

**Mechanistic**: the collect build's cycle attribution
(``repro_torch.core.telemetry``) — per-module fractions of where the
cycles went, per app, at the Table-2 config and at ``mshrs=1``.

The consistency gate:

* ``exec_interconnect`` visible cycles > 0  <=>  manip_share > 0
* ``dep_scalar`` coupling cycles > 0        <=>  app in scalar_comm
* mshr_bound apps: the memory fraction jumps > 0.3 under mshrs=1 and
  memory becomes the top bottleneck; every other app moves < 0.02
* the mechanistic top bottleneck is one the differential busy fractions
  allow (lanes / memory dominance at the same config)

The last line reads ``mechanistic <-> differential: CONSISTENT (10/10
apps)`` when every check holds; the exit code is 0 then, else 1.  The
engine runs on the CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import engine as eng
from repro_torch.core import isa, telemetry, tracegen

# paper Table 2 rows checked quantitatively (extended with the three
# frontend-derived ML workloads):
#   interconnect-heavy (slides/reductions): jacobi-2d, pathfinder,
#       canneal/streamcluster (reductions), the attention kernels
#       (online-softmax + dot reductions), ssd_scan (cumsum slide ladder)
#   indexed memory: canneal
#   intensive scalar-core communication: canneal, particlefilter,
#       streamcluster, and both attention kernels (the m/l running-statistics
#       update consumes the reductions' scalar results)
EXPECT = {
    "interconnect": {"jacobi-2d", "pathfinder", "canneal", "streamcluster",
                     "flash_attention", "decode_attention", "ssd_scan"},
    "indexed": {"canneal"},
    "scalar_comm": {"canneal", "particlefilter", "streamcluster",
                    "flash_attention", "decode_attention"},
    # MSHR saturation: only indexed-pattern apps are gated by the
    # demand-miss file; unit/strided streams ride the prefetch window
    "mshr_bound": {"canneal"},
}


def _cfgs(mvl: int):
    return (eng.VectorEngineConfig(mvl=mvl, lanes=4),
            eng.VectorEngineConfig(mvl=mvl, lanes=4, mshrs=1))


def shares_all(app_names, mvl=64, device=None) -> dict:
    """Static trace shares + simulated busy fractions for many apps at once:
    the timing simulations (the mshrs=1 saturation point too) are one
    ``simulate_batch`` launch."""
    cfg, cfg_m1 = _cfgs(mvl)
    bodies = [tracegen.APPS[a].body(mvl, None) for a in app_names]
    tiles = [b.tile(16) for b in bodies]
    sims = eng.simulate_batch(tiles + tiles, [cfg] * len(tiles)
                              + [cfg_m1] * len(tiles), device=device)
    rows = {}
    for i, (app_name, body) in enumerate(zip(app_names, bodies)):
        sim, sim_m1 = sims[i], sims[i + len(bodies)]
        n_vec = np.sum(body.kind != isa.SCALAR_BLOCK)
        manip = np.isin(body.kind, (isa.VSLIDE, isa.VREDUCE)).sum()
        indexed = ((body.kind == isa.VLOAD)
                   & (body.mem_pattern == isa.MEM_INDEXED)).sum()
        dep = body.dep_scalar.sum()
        rows[app_name] = {
            "manip_share": manip / max(n_vec, 1),
            "indexed_share": indexed / max(n_vec, 1),
            "dep_scalar_per_body": float(dep),
            "vmu_busy_frac": sim["vmu_busy"] / sim["time"],
            "lane_busy_frac": sim["lane_busy"] / sim["time"],
            "mshr1_slowdown": sim_m1["time"] / sim["time"],
        }
    return rows


def mechanistic_all(app_names, mvl=64, device=None) -> dict:
    """Cycle-attribution profile per app at the Table-2 config and its
    mshrs=1 ablation: ``telemetry.profile_app`` rows and the memory
    fraction's jump."""
    cfg, cfg_m1 = _cfgs(mvl)
    rows = {}
    for a in app_names:
        r = telemetry.profile_app(a, cfg, tiles=16, device=device)
        r1 = telemetry.profile_app(a, cfg_m1, tiles=16, device=device)
        rows[a] = {"default": r, "mshr1": r1,
                   "mem_jump": (r1["modules"]["memory"]
                                - r["modules"]["memory"])}
    return rows


def _allowed_tops(diff_row: dict) -> set[str]:
    """Which top bottleneck the differential busy fractions admit: any
    module whose unit is busy >50% of the time; if nothing dominates, the
    busier of lanes/memory."""
    allowed = set()
    if diff_row["lane_busy_frac"] > 0.5:
        allowed.add("lanes")
    if diff_row["vmu_busy_frac"] > 0.5:
        allowed.add("memory")
    if not allowed:
        allowed.add("lanes" if diff_row["lane_busy_frac"]
                    >= diff_row["vmu_busy_frac"] else "memory")
    return allowed


def check_consistency(diff: dict, mech: dict) -> list[str]:
    """Cross-check the differential matrix against the mechanistic
    attribution; returns the mismatches (empty = agree)."""
    bad = []
    for a in diff:
        d, m = diff[a], mech[a]
        stalls = m["default"]["stalls"]
        intc = stalls["exec_interconnect"]
        if (intc > 0) != (d["manip_share"] > 0):
            bad.append(f"{a}: interconnect visible={intc:.0f} vs "
                       f"manip_share={d['manip_share']:.2%}")
        dep = stalls["dep_scalar"]
        if (dep > 0) != (a in EXPECT["scalar_comm"]):
            bad.append(f"{a}: dep_scalar visible={dep:.0f} vs scalar_comm="
                       f"{'yes' if a in EXPECT['scalar_comm'] else 'no'}")
        if a in EXPECT["mshr_bound"]:
            if not (m["mem_jump"] > 0.3
                    and m["mshr1"]["top"] == "memory"):
                bad.append(f"{a}: mshr_bound but mem_jump={m['mem_jump']:.3f}"
                           f" top@mshr1={m['mshr1']['top']}")
        elif abs(m["mem_jump"]) > 0.02:
            bad.append(f"{a}: not mshr_bound but mem_jump={m['mem_jump']:.3f}")
        allowed = _allowed_tops(d)
        if m["default"]["top"] not in allowed:
            bad.append(f"{a}: mechanistic top={m['default']['top']} but busy "
                       f"fractions admit {sorted(allowed)}")
    return bad


def checkmarks(rows: dict) -> bool:
    """The Table-2 checkmark matrix from the differential rows alone."""
    ok = True
    for a in EXPECT["interconnect"]:
        ok &= rows[a]["manip_share"] > 0.0
    for a in EXPECT["indexed"]:
        ok &= rows[a]["indexed_share"] > 0.0
    for a in EXPECT["scalar_comm"]:
        ok &= rows[a]["dep_scalar_per_body"] > 0
    for a in EXPECT["mshr_bound"]:
        ok &= rows[a]["mshr1_slowdown"] > 1.2
    for a in set(tracegen.APPS) - EXPECT["mshr_bound"]:
        ok &= rows[a]["mshr1_slowdown"] < 1.05
    # blackscholes/jacobi/pathfinder have no dep-scalar round trips
    for a in set(tracegen.APPS) - EXPECT["scalar_comm"] - {"swaptions"}:
        ok &= rows[a]["dep_scalar_per_body"] == 0
    return bool(ok)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.module_stress",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    args = ap.parse_args(argv)
    apps = list(tracegen.APPS)
    rows = shares_all(apps, device=args.device)
    mech = mechanistic_all(apps, device=args.device)
    print(f"{'app':16s} {'manip%':>7s} {'indexed%':>9s} {'dep/body':>9s} "
          f"{'vmu busy':>9s} {'lane busy':>10s} {'mshr1 x':>8s}")
    for a, r in rows.items():
        print(f"{a:16s} {r['manip_share']:7.1%} {r['indexed_share']:9.1%} "
              f"{r['dep_scalar_per_body']:9.0f} {r['vmu_busy_frac']:9.2f} "
              f"{r['lane_busy_frac']:10.2f} {r['mshr1_slowdown']:8.2f}")
    print("\nmechanistic attribution (fraction of runtime per module):")
    print(f"{'app':16s} {'top':10s} "
          + " ".join(f"{m:>7s}" for m in telemetry.MODULES)
          + f" {'mem@mshr1':>10s}")
    for a in apps:
        r = mech[a]["default"]
        print(f"{a:16s} {r['top']:10s} "
              + " ".join(f"{r['modules'][m]:7.3f}" for m in telemetry.MODULES)
              + f" {mech[a]['mshr1']['modules']['memory']:10.3f}")

    ok = checkmarks(rows)
    print("\nTable-2 checkmark matrix:", "CONSISTENT" if ok else "MISMATCH")
    bad = check_consistency(rows, mech)
    if bad:
        print("\nmechanistic <-> differential MISMATCH:")
        for line in bad:
            print(" ", line)
    else:
        print(f"mechanistic <-> differential: CONSISTENT "
              f"({len(apps)}/{len(apps)} apps)")
    return 0 if ok and not bad else 1


if __name__ == "__main__":
    raise SystemExit(main())
