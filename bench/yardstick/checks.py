"""The comparison that decides ``correct``: the numbers compared, each
against its limit from ``bench/limits/<workload>.json``.

A "leaf" here is one layer's slice of a stacked parameter (the layers are
the leading axis of each leaf under ``blocks``) or a whole unstacked
parameter, named ``blocks.attn.wq[3]`` or ``embed.embedding``.
"""
from __future__ import annotations

import statistics
import sys

import torch

# a leaf whose gradient in the reference is below this share of the median
# leaf's is nought to rounding (a key's bias under softmax) and left out of
# the leaf comparisons
NOUGHT = 1e-3


def slice_norms(path: tuple, t: torch.Tensor) -> dict:
    """{leaf name: its float32 L2 norm as a 0-d device tensor}."""
    name = ".".join(path)
    x = t.detach().to(torch.float32)
    if path[0] == "blocks":
        n = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)
        return {f"{name}[{i}]": n[i] for i in range(x.shape[0])}
    return {name: torch.linalg.vector_norm(x)}


def as_floats(d: dict) -> dict:
    if not d:
        return {}
    keys = list(d)
    vals = torch.stack([d[k].to("cpu") if d[k].device.type != "cpu" else d[k]
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


def worst(x: float, y: float) -> float:
    """The larger of two readings, a NaN worst of all."""
    if x != x or y != y:
        return float("nan")
    return max(x, y)


def leaf_gap(prog: dict, ref: dict, ref_grad: dict) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf; leaves whose reference gradient is nought to rounding are left
    out.  Returns (gap, leaf)."""
    med_g = statistics.median(ref_grad.values())
    keep = [n for n in ref if ref_grad[n] >= NOUGHT * med_g]
    med = statistics.median(ref[n] for n in keep)
    out, name = 0.0, ""
    for n in keep:
        if n not in prog:
            return float("inf"), n
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not g <= out:            # a NaN is worst
            out, name = g, n
            if g != g:
                break
    return out, name


def rel_gaps(prog: list, ref: list) -> float:
    """The largest |program - reference| / |reference| over pairs."""
    if len(prog) != len(ref):
        return float("inf")
    out = 0.0
    for p, r in zip(prog, ref):
        out = worst(out, abs(p - r) / max(abs(r), 1e-30))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the cell's limits name within its limit, {name:
    {"value", "limit"}} of those).  A number the limits name and the run
    did not read fails; a cell whose limits name none is never correct.
    Readings the limits do not name are not compared (``readings``)."""
    table = limits.get("numbers", {})
    out, ok = {}, bool(table)
    for name, spec in table.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": spec["limit"]}
        if not value <= spec["limit"]:
            ok = False
    return ok, out


def readings(numbers: dict, limits: dict) -> dict:
    """The readings the cell does not compare (no limit holds for them)."""
    table = limits.get("numbers", {})
    return {k: v for k, v in numbers.items() if k not in table}


def report(checks: dict, other: dict) -> None:
    """The readings not compared, then each compared number beside its
    limit, as the run's last lines on standard error."""
    for name, v in other.items():
        print(f"reading {name} = {v!r} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
