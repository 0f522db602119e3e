"""The port stands alone: no module of ``clip_gp_tpu_torch`` and neither
``chip_smoke.py`` nor ``chip_ab.py`` imports ``jax``, ``optax`` or anything of the JAX package
``clip_gp_tpu``, at module level or inside a function. Every module of the
port imports in a process where those packages cannot be imported, and where
neither ``triton`` nor a CUDA toolkit is needed.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "clip_gp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "clip_gp_tpu")
SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_ab.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value, node.lineno


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = [
        f"{path.relative_to(REPO)}:{line} imports {name}"
        for name, line in _imported_roots(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_every_port_module_imports_without_jax():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PACKAGE.rglob("*.py"))
    ]
    blocked = ", ".join(f"{name!r}: None" for name in FORBIDDEN + ("triton",))
    code = (
        f"import sys; sys.modules.update({{{blocked}}}); import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok', len(sys.modules))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
