"""BENCHMARK.json against the benchmark's contract, and every file it names
present under ``bench/``."""
import json
import re

import pytest

from bench_small import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"experts_per_tok|_dim$|_rank$|ff|width)", re.I)
CELLS = [w["name"] for w in MAN["workloads"]]


def _reports(metric, cell):
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        target = next(m for m in MAN["end_to_end"] if m["name"] == metric["moves"])
        return _reports(target, cell)
    return True


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and (ROOT / p).is_dir()
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    need = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_text(kind):
    entries = MAN[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k], (e["name"], k)


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
        for w in m.get("workloads", []):
            assert w in CELLS


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in CELLS and _reports(e2e[m["moves"]], w), (m["name"], w)
        # its reader is a file of its own, found by the name
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()


def test_layers_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in MAN["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) for m in MAN["per_layer"])


def test_cells_name_known_files_and_fit_the_chip_rule():
    pairs = set()
    names = {c["name"] for c in MAN["configs"]}
    four = 0
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").is_file()
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_every_configuration_keeps_a_cell():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["source"].startswith("https://")
    assert any(cfg["file"].startswith(p + "/") for p in MAN["paths"])
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data and not WIDTH.search(key), key
        assert data["published"][key] != data[key]
    assert sorted(cfg["reduced"]) == sorted(data["reduced"])
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_program_widths_are_the_published_ones(cfg):
    d = json.loads((ROOT / cfg["file"]).read_text())
    p = d["program"]
    assert p["d_model"] == d["hidden_size"]
    assert p["num_layers"] == d["num_hidden_layers"]
    assert p["num_heads"] == d["num_attention_heads"]
    assert p["num_kv_heads"] == d["num_key_value_heads"]
    assert p["head_dim"] * p["num_heads"] == d["hidden_size"]
    assert p["d_ff"] == d["intermediate_size"]
    assert p["vocab_size"] == d["vocab_size"]
    assert p["norm_eps"] == d["rms_norm_eps"]
    assert p["rope_theta"] == d["rope_theta"]
    assert p["tie_embeddings"] == d["tie_word_embeddings"]
    assert p["dtype"] == d["torch_dtype"]
    if "num_local_experts" in d:
        assert p["num_experts"] == d["num_local_experts"]
        assert p["experts_per_token"] == d["num_experts_per_tok"]
