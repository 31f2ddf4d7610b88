"""The spreads that set the bounds, from the runs ``sets.sh`` left:

    python3 bench/tools/spread.py <out>/<cell>

For each set and each end-to-end metric: the median, the quartiles
(``statistics.quantiles(values, n=4)``) and the spread (the distance
between them over the median); the set's first run, which builds the
kernels, is left out of ``setup_s``.  Then, for each metric, the spreads
a check reads: ``tight`` the mean of the two sets' spreads, each set's run
farthest from its median left out (a bound is too tight under twice it),
and ``loose`` the spread of all the runs together (a bound is too loose
over eight times it).  Also each run's ``correct`` and the readings
compared."""
import json
import statistics
import sys
from pathlib import Path


def lines(folder: Path, prefix: str):
    out = []
    for f in sorted(folder.glob(f"{prefix}.*.out")):
        text = f.read_text().strip().splitlines()
        if text:
            out.append((int(f.name.split(".")[1]), json.loads(text[-1])))
    return out


def spread(vals) -> float:
    q1, _, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / statistics.median(vals)


def less_farthest(vals) -> list:
    med = statistics.median(vals)
    far = max(range(len(vals)), key=lambda i: abs(vals[i] - med))
    return vals[:far] + vals[far + 1:]


def main():
    folder = Path(sys.argv[1])
    first = None
    by_set = {}
    for s in (1, 2):
        runs = lines(folder, f"set{s}")
        if not runs:
            continue
        first = first or min(seed for seed, _ in runs)
        print(f"set {s}: seeds {[seed for seed, _ in runs]}, correct "
              f"{[r['correct'] for _, r in runs]}")
        for name in runs[0][1]["metrics"]:
            vals = [r["metrics"][name]["value"] for seed, r in runs
                    if not (name == "setup_s" and s == 1 and seed == first)]
            by_set.setdefault(name, []).append(vals)
            q1, med, q3 = statistics.quantiles(vals, n=4)
            print(f"  {name}: median {statistics.median(vals)!r} quartiles "
                  f"{q1!r} {q3!r} spread {(q3 - q1) / statistics.median(vals)!r}"
                  f" values {vals}")
        for name in runs[0][1]["checks"]:
            vals = [r["checks"][name]["value"] for _, r in runs]
            print(f"  check {name}: max {max(vals)!r} (limit "
                  f"{runs[0][1]['checks'][name]['limit']})")
    for name, sets in by_set.items():
        if len(sets) == 2:
            tight = statistics.mean(spread(less_farthest(v)) for v in sets)
            print(f"{name}: tight {tight!r} loose {spread(sets[0] + sets[1])!r}"
                  f" medians {[statistics.median(v) for v in sets]}")
    for seed, r in lines(folder, "trace"):
        print(f"traced {seed}: correct {r['correct']}, "
              f"{json.dumps(r['metrics'])}, busy {r['device']['busy_s']} of "
              f"{r['device']['window_s']}, peak {r['device']['memory_peak_bytes']}")


if __name__ == "__main__":
    main()
