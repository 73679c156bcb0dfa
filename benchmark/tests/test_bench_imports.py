"""What the benchmark loads: never JAX or the JAX package; the reference not
even the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

from .conftest import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "sphtpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(folder):
    for base, _, files in os.walk(folder):
        if "tests" in base.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        assert not imported_tops(path) & BANNED, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        assert not imported_tops(path) & (BANNED | {"sphtpu_torch"}), path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sphtpu_torch_fake.x", sys)
    assert "sphtpu" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "sphtpu.fake", sys)
    assert "sphtpu" in harness.foreign_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package(small_root):
    code = (
        "import sys, time; t = time.perf_counter(); sys.path[:0] = [%r, %r];"
        "from benchmark import harness;"
        "harness.execute(%r, 'tiny.blocks', 3, 0.01, False, device='cpu', t_start=t);"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
        % (small_root, ROOT, small_root, BANNED))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
