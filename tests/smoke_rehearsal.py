"""What the rehearsals of ``chip_smoke.py``'s phases share
(``tests/test_torch_smoke_*.py``): the script loaded as a module, whether
a card is present, the launch counts of a run with no kernel, and an
autouse fixture (in the files that import it) that keeps the rehearsal's
process on one torch thread."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

NO_LAUNCHES = {"flash_attention": 0, "group_average_combine": 0,
               "group_average_combine_multi": 0, "rglru_scan": 0,
               "rglru_scan_tma": 0, "rglru_scan_walk": 0}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The rehearsal's own process on one torch thread: its small ops gain
    nothing from more, and under the suite's parallel workers more
    threads only contend (a stacked twin's steps slow by tens of
    times)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def has_cuda() -> bool:
    import torch
    return torch.cuda.is_available()


def load_chip_smoke():
    """``chip_smoke.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke
