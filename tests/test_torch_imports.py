"""The port stands alone: every ``repro_torch`` module and
``chip_smoke.py`` import with ``jax`` and the JAX package blocked, and
no import statement in them names either.
"""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jaxlib", "repro")
                or (m.split(".")[0] == "jax" and sys.modules[m] is not None))
assert not leaked, leaked
print(len(names))
"""


def _top(name):
    return name.split(".")[0] if name else ""


def test_every_module_imports_without_jax_or_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30     # modules walked


def test_no_import_statement_names_jax_or_reference():
    bad = []
    for f in FILES:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad += [f"{f.name}: {m}" for m in mods
                    if _top(m) in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert len(FILES) > 25
