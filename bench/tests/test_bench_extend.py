"""A later change adds a traffic mix, a per-layer metric and a cell as new
files and entries, and the harness takes them with no file edited."""
import json
import shutil

from bench_small import ROOT, run_small, small_cell


def test_a_new_mix_metric_and_cell_need_no_edit(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "bench/traffic/prefill-4k.json").read_text())
    mix["length"] = dict(mix["length"], median=800, sigma=0.3)
    (tmp_path / "bench/traffic/dummy-mix.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/dummy_waves.serve.py").write_text(
        '"""Waves the traced window ran."""\n\n\n'
        'def read(rec):\n    return rec.work.get("waves")\n')
    cell = "qwen2.5-3b.dummy-mix"
    man["workloads"].append({"name": cell, "config": "qwen2.5-3b",
                             "traffic": "dummy-mix", "chips": 1,
                             "why": "a test's cell"})
    man["per_layer"].append({"name": "dummy_waves.serve", "unit": "waves",
                             "better": "higher", "source": "program_counter",
                             "layer": "serve engine",
                             "moves": "serve_tokens_per_s",
                             "workloads": [cell]})
    for m in man["end_to_end"]:
        if m["name"] in ("serve_tokens_per_s", "request_latency_p95_s"):
            m["workloads"].append(cell)
    shutil.copy(ROOT / "bench/limits/qwen2.5-3b.prefill-4k.json",
                tmp_path / f"bench/limits/{cell}.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    sc = small_cell(cell, root=tmp_path)
    assert sc.traffic["length"]["median"] == 20      # tiny, from the new mix
    rc, line, err = run_small(cell, root=tmp_path, trace=1, cell=sc)
    assert rc == 0, err
    assert line["metrics"]["dummy_waves.serve"]["value"] > 0
    rc, line, err = run_small(cell, root=tmp_path, cell=sc)
    assert set(line["metrics"]) == {"serve_tokens_per_s",
                                    "request_latency_p95_s", "setup_s"}
