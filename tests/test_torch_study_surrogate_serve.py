"""Port parity: ``repro_torch.study --surrogate`` and ``--serve`` against
``benchmarks/run.py``'s ``surrogate_rows`` and ``serve_bench.serve_study``.

Both run here at a test size, on the CPU: the quick mode's spaces (and its
app preset) are swapped for small ones in both packages, and the serving
study's stream for 16 requests.  Each side's rows carry the same names in
the same order, and the same ``derived`` fields in the same formats (every
number masked); the machine-readable section holds the reference's keys;
and the gates hold: recall 1.0 with every frontier point exact-verified,
and the serving study's repeat pass all hits, bitwise, with no rebuild.
The quick and full modes at their own sizes run on the card only
(``chip_smoke.py``).
"""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))

import run as ref_run  # noqa: E402
import serve_bench as ref_sb  # noqa: E402
from repro.configs import vector_engine as ref_vcfg  # noqa: E402
from repro.core import dse as ref_dse  # noqa: E402
from repro.serve import sim_service as ref_svc  # noqa: E402
from repro_torch import serve_bench, study  # noqa: E402
from repro_torch.configs import vector_engine as vcfg  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.serve import sim_service  # noqa: E402

APPS = ("blackscholes", "canneal")
NUM = re.compile(r"[-+]?\d[\d,]*(\.\d+)?(e[-+]?\d+)?")


def shape(derived: str) -> str:
    """A ``derived`` field with every number masked: its format."""
    return NUM.sub("#", derived)


def small_spaces(monkeypatch, vmod, dmod):
    monkeypatch.setattr(vmod, "SPACE_QUICK", dmod.DesignSpace.of(
        "tq", mvl=(8, 64), lanes=(1, 8), l2_kb=(256, 1024)))
    monkeypatch.setattr(vmod, "SPACE_10K", dmod.DesignSpace.of(
        "ts", mvl=(8, 16, 64), lanes=(1, 2, 8), l2_kb=(256, 1024),
        mshrs=(4, 16)))
    monkeypatch.setattr(vmod, "SPACE_PRESET_APPS",
                        dict(vmod.SPACE_PRESET_APPS, quick=APPS))


def run_study(argv, capsys) -> list[tuple]:
    assert study.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[-1].startswith("# wrote ")
    return [tuple(ln.split(",", 2)) for ln in lines[1:-1]]


def test_surrogate_rows_match_reference(monkeypatch, tmp_path, capsys):
    small_spaces(monkeypatch, vcfg, dse)
    small_spaces(monkeypatch, ref_vcfg, ref_dse)
    bench = tmp_path / "bench.json"
    got = run_study(["--surrogate", "--quick", "--device", "cpu",
                     "--surrogate-cache", str(tmp_path / "s.jsonl"),
                     "--bench-json", str(bench)], capsys)
    ref_run._BENCH.clear()
    want = ref_run.surrogate_rows(quick=True,
                                  cache_path=str(tmp_path / "r.jsonl"))
    assert [g[0] for g in got] == [w[0] for w in want] == [
        "surrogate_train_16rows", "surrogate_score_ts",
        "surrogate_search_ts_36cfg", "surrogate_recall_tq_truth"]
    assert [shape(g[2]) for g in got] == [shape(w[2]) for w in want]
    sec = json.loads(bench.read_text())["surrogate"]
    assert set(ref_run._BENCH["surrogate"]) <= set(sec)
    assert sec["device"] == "cpu"
    assert sec["recall_mean"] == sec["recall_min"] == 1.0
    assert sec["frontier_points_exact_verified"] > 0
    assert sec["search_stats"]["mode"] == "exhaustive-score"
    assert [p["phase"] for p in sec["search_stats"]["phases"]] == \
        ["score", "resim", "refine"]
    assert "mean=1.000|min=1.000" in got[3][2]


def test_serve_rows_match_reference(monkeypatch, tmp_path, capsys):
    def workload(mod, vmod):
        def _workload(quick, seed):
            cfgs = tuple(vmod.SPACE_SMOKE.sample(4, seed=seed + 1))
            return (mod.poisson_arrivals(16, 400.0, APPS, cfgs, seed=seed),
                    APPS, cfgs, 400.0)
        return _workload

    monkeypatch.setattr(serve_bench, "_workload",
                        workload(sim_service, vcfg))
    monkeypatch.setattr(ref_sb, "_workload", workload(ref_svc, ref_vcfg))
    bench = tmp_path / "bench.json"
    got = run_study(["--serve", "--quick", "--device", "cpu",
                     "--serve-cache", str(tmp_path / "s.jsonl"),
                     "--bench-json", str(bench)], capsys)
    want, want_bench = ref_sb.serve_study(quick=True,
                                          cache_path=str(tmp_path / "r.jsonl"))
    assert [g[0] for g in got] == [w[0] for w in want] == [
        "serve_quick_throughput", "serve_quick_latency",
        "serve_quick_batching", "serve_quick_repeat"]
    assert [shape(g[2]) for g in got] == [shape(w[2]) for w in want]
    sec = json.loads(bench.read_text())["serve"]
    assert set(want_bench) <= set(sec)
    assert set(want_bench["pass1"]) == set(sec["pass1"])
    assert sec["ok"] and sec["bitwise_repeat"] and sec["device"] == "cpu"
    assert sec["pass1"]["recompiles"] == 0 and sec["pass1"]["shed"] == 0
    assert sec["repeat"]["hit_fraction"] == 1.0
    assert sec["prewarmed_buckets"] == want_bench["prewarmed_buckets"] == 2
    assert "recompiles=0" in got[2][2]
    assert got[3][2].endswith("|bitwise|ok")


@pytest.mark.parametrize("flag", ["--surrogate", "--serve"])
def test_flags_select_one_group(flag):
    args = study.parse_args([flag, "--device", "cpu"])
    groups = study.row_groups(args)
    assert [name for name, _ in groups] == [flag[2:]]
    assert str(args.surrogate_cache).endswith("results/surrogate_cache.jsonl")
    assert str(args.serve_cache).endswith("results/serve_cache.jsonl")
