"""Nothing the benchmark runs loads JAX or the JAX package, and its plain
reference loads nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import json
import pathlib
import subprocess
import sys

from benchmark import run

from conftest import ROOT, TINY

BENCH = pathlib.Path(ROOT) / "benchmark"
YARDSTICK = ["benchmark.reference.sage", "benchmark.reference.precision",
             "benchmark.reference.draws", "benchmark.compare",
             "benchmark.counts", "benchmark.graphgen"]


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        for name in ("jaxtyping", "graphsage_torch", "graphsage_tpux"):
            sys.modules.setdefault(name, sys)
        assert run.forbidden_modules() == []
        sys.modules["graphsage_tpu.models"] = sys
        assert run.forbidden_modules() == ["graphsage_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    tiny = json.dumps(TINY["train_plus_unsup_pubmed_b20"])
    loaded = _modules_after(
        "import json\nfrom benchmark import run\n"
        "rc = run.main(['--workload', 'train_plus_unsup_pubmed_b20', "
        "'--seed', '5', '--seconds', '0.2', '--trace', '0'], "
        f"device='cpu', overrides=json.loads({tiny!r}))\n"
        "assert rc == 0, rc\n"
        "import benchmark.kinds.train_cached, benchmark.kinds.embed\n"
        "from benchmark import harness\n"
        "[harness.reader(p.stem) for p in "
        "harness.BENCH.joinpath('metrics').glob('*.py')]")
    assert "graphsage_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import " + ", ".join(YARDSTICK))
    assert not loaded & ({"graphsage_torch"} | set(run.FORBIDDEN))


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in {"graphsage_torch"} | set(run.FORBIDDEN), \
                    (path.name, name)
