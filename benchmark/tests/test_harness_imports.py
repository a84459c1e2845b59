"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "pixelnerf_yolo_tpu"}
PROGRAM = "pixelnerf_yolo_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
    if "_cache" not in p.parts and "tests" not in p.parts))
def test_sources_import_no_jax(path):
    names = top_level_imports(BENCH / path)
    assert not names & FORBIDDEN
    if path.startswith("reference/"):
        assert PROGRAM not in names


def loaded_after(code):
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    import json

    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after("import benchmark.reference.nets, "
                        "benchmark.reference.render, "
                        "benchmark.reference.train")
    assert not mods & (FORBIDDEN | {PROGRAM})


def test_a_run_loads_no_jax():
    """Each cell at test size through set-up, the window and the check."""
    mods = loaded_after(
        "import sys, time; sys.path.insert(0, 'benchmark/tests')\n"
        "import torch; torch.set_num_threads(2)\n"
        "from conftest import tiny_cell\n"
        "from benchmark import harness\n"
        "for n in ('srn_views', 'yolo_train', 'yolo_detect'):\n"
        "    harness.execute(tiny_cell(n), 5, 0.1, True, 'cpu',"
        " time.perf_counter())")
    assert PROGRAM in mods
    assert not mods & FORBIDDEN
