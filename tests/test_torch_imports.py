"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or anything of the JAX package ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
JAX_PACKAGE_NAME = re.compile(r"\brepro(?!_torch)\b\.|\bimport\s+repro\b(?!_)"
                              r"|\bjax\b")

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "repro" or m.startswith(("repro.", "jax"))))
assert not leaked, leaked
print("MODULES", " ".join(names))
print("IMPORTED", len(names))
"""
# slice 6: elastic membership, the failure detector and seeded faults
SLICE_6_MODULES = ("repro_torch.core.elastic", "repro_torch.core.health",
                   "repro_torch.core.faults", "repro_torch.launch.elastic")


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split("IMPORTED")[1])
    assert n == len(list(PKG.rglob("*.py")))
    modules = out.stdout.split("MODULES")[1].split("IMPORTED")[0].split()
    assert set(SLICE_6_MODULES) <= set(modules)


@pytest.mark.parametrize("module", ["repro_torch.serve.kv_transfer",
                                    "repro_torch.serve.handoff"])
def test_slice_8_modules_import_without_jax(module):
    """The disaggregated-serving and handoff modules import with ``jax``
    blocked and load nothing of it or of ``repro``."""
    code = (f"import sys; sys.modules['jax'] = None; import {module}; "
            "leaked = sorted(m for m, mod in sys.modules.items() if mod "
            "is not None and (m == 'repro' or m.startswith(('repro.', "
            "'jax')))); assert not leaked, leaked")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_port_sources_never_name_jax_or_repro():
    for path in PORT_FILES:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#")[0]
            if code.lstrip().startswith(("import ", "from ")):
                assert not JAX_PACKAGE_NAME.search(code), \
                    f"{path.relative_to(ROOT)}:{i}: {line.strip()}"


def test_chip_smoke_needs_cuda():
    """Without a card the script exits non-zero and prints no result."""
    if _has_cuda():
        return
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _has_cuda() -> bool:
    import torch
    return torch.cuda.is_available()
