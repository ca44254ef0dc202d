"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX, ``ml_dtypes`` or the JAX package ``repro``
(the machine with the card has no JAX)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}
PORT = ROOT / "src" / "repro_torch"
# one case per subpackage (plus the package root and chip_smoke.py)
GROUPS = {p.name: sorted(p.rglob("*.py")) for p in sorted(PORT.iterdir())
          if p.is_dir() and (p / "__init__.py").exists()}
GROUPS["repro_torch"] = sorted(PORT.glob("*.py"))
GROUPS["chip_smoke.py"] = [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_port_imports_no_jax(group):
    assert GROUPS[group], f"no Python files in {group}"
    bad = [f"{path.relative_to(ROOT)}:{line} imports {mod}"
           for path in GROUPS[group]
           for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_checker_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import gemm\n"
                     "from repro_torch.core import gemm as g\n")
    assert [m for _, m in _imported_roots(probe)] == ["jax", "repro",
                                                       "repro_torch"]
