"""The import rule: nothing the benchmark runs imports JAX or the JAX
package (top-level names compared whole: ``reni_tpu_torch`` is not
``reni_tpu``), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

SOURCES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_and_no_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top in {"__future__", "math", "numpy", "torch", "typing", "statistics"} or (
            name.startswith("portbench.reference")), name


def test_a_run_loads_no_jax():
    """Every module a run imports, the program's included, leaves no JAX
    module in ``sys.modules``."""
    code = (
        "import portbench.run, portbench.readings, portbench.training\n"
        "import portbench.drivers.fit_decoder, portbench.drivers.fit_inverse\n"
        "import reni_tpu_torch.core.sphere, reni_tpu_torch.models.reni\n"
        "import reni_tpu_torch.train.tasks, reni_tpu_torch.train.checkpoint\n"
        "import reni_tpu_torch.render.inverse, reni_tpu_torch.data.transforms\n"
        "import reni_tpu_torch.parallel.mesh, reni_tpu_torch.parallel.multihost\n"
        "from portbench import harness\n"
        "print(harness.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reni_tpu_torch_x", sys)
    assert "reni_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "reni_tpu.models", sys)
    assert "reni_tpu" in harness.forbidden_modules()
