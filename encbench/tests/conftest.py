"""encbench's own tests, on the CPU: ``python -m pytest encbench/tests``.

Tests that need the CUDA card carry the ``card`` marker and skip without
one; on the card they run with ``python -m pytest encbench/tests -m card``.
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return "cuda"


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_spec(workload, trace=False):
    """The cell's spec at a size a CPU test run holds: 160x96, key frames at
    least 4 apart, 8-frame scenes, a 2 x 5-frame warm-up, 6 fixed frames."""
    from encbench import harness

    spec = harness.load_spec(workload, trace)
    spec.config = dict(copy.deepcopy(spec.config), width=160, height=96,
                       min_key_frame_interval=4, fixed_frames=6)
    spec.traffic = copy.deepcopy(spec.traffic)
    spec.traffic["content"]["scene_frames"] = 8
    spec.traffic["warmup"] = {"scene_frames": 5, "scenes": 2}
    return spec


def tiny_run(workload, seconds=2.0, seed=2**31 + 7, breakage=None,
             trace=False, control=False):
    import time

    from encbench import harness

    return harness.run_cell(tiny_spec(workload, trace), seed, seconds, trace,
                            time.monotonic(), device="cpu", workers=1,
                            breakage=breakage, control=control)
