"""Nothing under ``perfbench/`` imports JAX or the JAX package ``repro``
(top-level module names compared whole: ``repro_torch`` is not
``repro``), and the plain references import nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FILES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Every module ``path`` imports, by absolute name, including through
    ``importlib.import_module`` / ``__import__`` with a constant name."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", getattr(node.func, "attr", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(HERE)) for p in FILES])
def test_no_jax_import(path):
    for mod in imported(path):
        assert mod.split(".")[0] not in FORBIDDEN, \
            f"{path.relative_to(HERE)} imports {mod}"


REFERENCE = sorted((HERE / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[str(p.relative_to(HERE)) for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    for mod in imported(path):
        top = mod.split(".")[0]
        assert top != "repro_torch", f"{path.relative_to(HERE)} imports {mod}"
        assert top in {"torch", "numpy", "math", "typing", "__future__",
                       "perfbench"}, f"{path.relative_to(HERE)} imports {mod}"
        if top == "perfbench":
            assert mod.startswith("perfbench.reference"), mod


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom reprox import y\n"
                 "import jax.numpy\n")
    tops = [m.split(".")[0] for m in imported(f)]
    assert tops == ["repro_torch", "reprox", "jax"]
    assert [t in FORBIDDEN for t in tops] == [False, False, True]
