"""The port and its GPU smoke script import neither JAX nor the JAX package.

A static scan of the import statements (and of ``__import__`` /
``importlib.import_module`` calls with a literal name): the test process
has JAX loaded already, so a ``sys.modules`` check could not tell.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "hpddm_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "hpddm_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("__import__", "import_module"):
                yield node.lineno, node.args[0].value


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_scan_covers_the_port():
    files = _port_files()
    names = {os.path.relpath(f, ROOT) for f in files}
    assert "chip_smoke.py" in names
    assert os.path.join("hpddm_tpu_torch", "ops", "dia_spmv.py") in names
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_forbidden_matches_only_the_jax_packages():
    assert _forbidden("jax.numpy") and _forbidden("hpddm_tpu.ops.spmv")
    assert not _forbidden("hpddm_tpu_torch.ops.spmv")
    assert not _forbidden("jaxtyping")
