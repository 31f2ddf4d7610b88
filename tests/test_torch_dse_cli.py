"""The port's DSE command lines on the CPU: ``python -m
repro_torch.core.dse --smoke`` (the double-run determinism gate) and
``python -m repro_torch.study --dse --quick`` (``benchmarks/run.py
--dse --quick``'s rows), whose repeat run through the same cache must
report ``hit_rate=1.000`` and the same frontier fingerprint."""
from repro_torch import study
from repro_torch.configs import vector_engine as vcfg
from repro_torch.core import dse

CPU = "cpu"


def test_dse_smoke_gate(tmp_path, capsys):
    cache = str(tmp_path / "smoke.jsonl")
    assert dse.main(["--space", "smoke", "--smoke", "--device", CPU,
                     "--cache", cache]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("space=smoke (64 configs) x 2 apps -> 128 cells")
    assert "simulated=128" in out[0]
    assert out[-1].endswith("hit_rate=100.0% frontier bitwise-identical -> ok")
    # a third run reads the file: nothing simulated
    assert dse.main(["--space", "smoke", "--device", CPU,
                     "--cache", cache]) == 0
    assert "simulated=0 hit_rate=100.0%" in capsys.readouterr().out


def _rows(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[-1].startswith("# wrote ")     # the bench sections' file
    return {ln.split(",")[0]: ln.split(",", 2)[2] for ln in lines[1:-1]}


def test_study_dse_quick_repeats_from_the_cache(tmp_path, capsys):
    cache = str(tmp_path / "dse.jsonl")
    args = ["--dse", "--quick", "--device", CPU, "--dse-cache", cache,
            "--bench-json", str(tmp_path / "bench.json")]
    assert study.main(args) == 0
    first = _rows(capsys)
    apps = vcfg.SPACE_PRESET_APPS["quick"]
    head = f"dse_quick_384cfg_{len(apps)}apps"
    assert set(first) == {head} | {f"dse_frontier_{a}" for a in apps}
    assert "|hit_rate=0.000|" in first[head]
    assert study.main(args) == 0
    again = _rows(capsys)
    assert "|simulated=0|hit_rate=1.000|" in again[head]
    fp = lambda row: row.split("frontier_fp=")[1]
    assert fp(again[head]) == fp(first[head])
    assert {k: v for k, v in again.items() if k != head} == \
        {k: v for k, v in first.items() if k != head}
