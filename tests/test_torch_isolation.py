"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or any module of the JAX package ``repro``,
directly or through another module."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        f"    {FORBIDDEN!r})\n"
        "print(len(mods), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src"))).stdout
    n, bad = out.strip().split(" ", 1)
    assert int(n) >= 20, out            # every subpackage was walked
    assert bad == "[]", out


def test_no_source_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            hits += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                     for n in names if _forbidden(n)]
    assert len(files) > 20
    assert hits == []
