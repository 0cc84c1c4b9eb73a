"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or anything of the JAX package ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

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
print("IMPORTED", len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split("IMPORTED")[1])
    assert n == len(list(PKG.rglob("*.py")))


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


def test_chip_smoke_phases_at_smoke_size_on_cpu():
    """chip_smoke's serving and profile phases, rehearsed on the CPU with
    the smoke config: every request finishes, the pool preempts, the paged
    path agrees with the dense one, and no kernel launches off the card."""
    import importlib.util

    import torch

    from repro_torch.configs import get_config

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config(smoke.ARCH, smoke=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # thousands of tiny ops: threads only contend
    try:
        model, params, _ = smoke.load_model(cfg, "cpu")
        stats = smoke.serve_phase(model, params, device="cpu")
        windows = smoke.profile_phase(model, params, device="cpu",
                                      decode_steps=1)
    finally:
        torch.set_num_threads(threads)
    assert stats["evictions"] > 0 and stats["n_prefills"] > smoke.N_REQUESTS
    assert stats["launches"] == {"flash_attention": 0}
    assert {tuple(s) for s in stats["decode_shapes"]} <= \
        {(b, smoke.MAX_BLOCKS_PER_REQ) for b in (1, 2, 4, 8)}
    assert [c["rid"] for c in stats["checks"]] == list(smoke.CHECKED_REQUESTS)
    assert all(w["device_busy_ms"] is None for w in windows.values())
