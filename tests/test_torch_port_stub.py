"""The port's committed stub (``spectrograms_tpu_torch/__init__.pyi``) covers
its surface and stays in sync: the four checks of ``tests/test_stub.py``,
on the port's generator (``spectrograms_tpu_torch/tools/gen_stub.py``)."""

import ast
import subprocess
import sys
from pathlib import Path

import spectrograms_tpu_torch as tg

REPO = Path(tg.__file__).resolve().parents[1]
STUB = Path(tg.__file__).with_name("__init__.pyi")


def _stub_top_level_names():
    tree = ast.parse(STUB.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def test_stub_exists_and_parses():
    assert STUB.exists(), "spectrograms_tpu_torch/__init__.pyi missing"
    assert STUB.with_name("py.typed").exists()
    ast.parse(STUB.read_text())


def test_stub_covers_every_public_name():
    missing = set(tg.__all__) - _stub_top_level_names()
    assert not missing, f"stub missing names: {sorted(missing)}"


def test_stub_has_docstring_coverage():
    tree = ast.parse(STUB.read_text())
    documented = total = 0
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            total += 1
            if ast.get_docstring(node):
                documented += 1
    assert total > 100
    assert documented / total > 0.75, f"only {documented}/{total} documented"


def test_stub_in_sync_with_runtime():
    """Regenerating the stub must be a no-op (run the generator if not)."""
    proc = subprocess.run(
        [sys.executable, "-m", "spectrograms_tpu_torch.tools.gen_stub", "--check"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr or proc.stdout
