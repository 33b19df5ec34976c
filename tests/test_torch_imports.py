"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports `repro_torch` and every submodule and must not
have pulled `jax` in; an AST scan of the port's sources, `chip_smoke.py`
and `chip_distill_recipes.py` rejects any import of `jax`, `jaxlib` or `repro` / `repro.*`.
"""

import _torch_threads  # noqa: F401

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_distill_recipes.py"]


def _modules() -> list[str]:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"mods = {_modules()!r}\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print('IMPORTED', len(mods), 'FORBIDDEN', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or without CUDA, chip_smoke exits non-zero and
    prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                          cwd=tmp_path, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
