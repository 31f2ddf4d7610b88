"""What a run loads: neither JAX nor the JAX package, by top-level names
compared whole (``repro_torch`` is not ``repro``); and the reference takes
nothing from the program."""
import ast
import json
import subprocess
import sys

from bench_small import ROOT, run_small

SCRIPT = f"""
import sys
sys.path.insert(0, {str(ROOT / 'bench' / 'tests')!r})
from bench_small import run_small
for cell in ("qwen2.5-3b.train-4k", "qwen2.5-3b.prefill-4k"):
    rc, line, err = run_small(cell, trace=1)
    assert rc == 0 and line["correct"], err
import json
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "yardstick" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_guard_compares_whole_top_level_names():
    from yardstick import device as D
    assert D.loaded_forbidden(["repro_torch.models", "reprox", "torch"]) == []
    assert D.loaded_forbidden(["repro.core", "jax", "jaxlib.xla",
                               "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                  "repro"]


def test_a_run_that_loads_jax_ends_without_a_result(monkeypatch):
    from repro_torch.serve import engine
    run = engine.ServeEngine.run

    def loads(self):
        sys.modules.setdefault("flax.bench_probe", sys)
        return run(self)

    monkeypatch.setattr(engine.ServeEngine, "run", loads)
    try:
        rc, line, err = run_small("qwen2.5-3b.prefill-4k")
    finally:
        sys.modules.pop("flax.bench_probe", None)
    assert rc != 0 and line is None
    assert "flax" in err


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_the_bench_sources_import_no_jax_and_the_reference_no_program():
    for path in (ROOT / "bench").rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops and "yardstick" not in tops, path
