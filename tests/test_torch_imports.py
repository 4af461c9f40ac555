"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``.  Read
with ``ast``, one case per file, so a forbidden import anywhere, even one
inside a function, fails here on the CPU before the card's machine (which
has no JAX) meets it."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "repro"


def imports_of(path: Path):
    """Every absolute module name imported anywhere in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in imports_of(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", [
    "core/collectives.py", "core/schedule_search.py",
    "core/product_schedule.py", "telemetry/metrics.py",
    "dist/tree_allreduce.py", "dist/striped.py", "dist/steps.py",
    "launch/train.py", "core/fault.py", "analysis/verify.py",
    "dist/fault.py", "optim/sharded.py", "dist/health.py",
    "dist/recovery.py", "ckpt/checkpoint.py", "dist/chaos.py",
    "launch/elastic.py"])
def test_the_engine_modules_are_checked(module):
    """The EDST engines, their compilers and telemetry are among the
    files checked above."""
    assert ROOT / "src" / "repro_torch" / module in FILES


def test_the_check_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro.models import x\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert [m for m in imports_of(f) if _forbidden(m)] == \
        ["repro.models", "jax.numpy"]
    assert len(FILES) > 40
