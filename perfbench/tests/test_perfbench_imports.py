"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared whole, by
their top-level part (``repro_torch`` is not ``repro``)."""

import ast
import sys
from pathlib import Path

from perfbench import harness

HERE = harness.HERE


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*, tests: bool):
    return [p for p in HERE.rglob("*.py") if tests or "tests" not in p.relative_to(HERE).parts]


def test_no_module_the_benchmark_runs_imports_jax_or_the_jax_package():
    for path in _sources(tests=False):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_and_the_judge_import_nothing_of_the_program():
    plain = list((HERE / "reference").glob("*.py")) + [HERE / "judge.py", HERE / "work.py"]
    for path in plain:
        assert "repro_torch" not in _imports(path) and not _imports(path) & set(harness.FORBIDDEN), path


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    # Other test files in this process may have loaded JAX or the JAX package.
    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]
