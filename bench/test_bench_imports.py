"""No run loads JAX or the JAX package: the check on whole top-level
names, the benchmark's sources, and a run's own process."""
import ast
import os
import subprocess
import sys

import harness

SOURCES = sorted(harness.BENCH.rglob("*.py"))


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.dist",
                                      "reproduce", "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(["repro.dist.steps", "jax",
                                      "jaxlib.xla_client", "flax.linen",
                                      "benchmarks.run"]) == \
        ["benchmarks", "flax", "jax", "jaxlib", "repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_sources_import_nothing_forbidden():
    for path in SOURCES:
        bad = harness.forbidden_modules(list(_imports(path)))
        assert not bad, (path, bad)


def test_references_import_nothing_of_the_program():
    for path in sorted((harness.BENCH / "reference").glob("*.py")):
        names = list(_imports(path))
        assert not [n for n in names if n.split(".")[0] == "repro_torch"], \
            (path, names)
        assert set(n.split(".")[0] for n in names) <= {
            "__future__", "math", "torch"}, (path, names)


def test_a_run_loads_nothing_forbidden():
    """A tiny run of each kind in a fresh interpreter, the way the
    harness runs one, then its ``sys.modules``."""
    code = (
        "import sys\n"
        "from bench_tiny import TINY_RUNS, tiny_result\n"
        "import harness\n"
        "for kind in TINY_RUNS:\n"
        "    tiny_result(kind, True)\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted(m for m in sys.modules if m.startswith('repro_torch'))"
        "[:1])\n")
    env = dict(os.environ, PYTHONPATH=str(harness.BENCH))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['repro_torch']"
