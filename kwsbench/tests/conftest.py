"""The benchmark's tests. Tests that need a CUDA card carry the ``card``
marker and take the ``card`` fixture, which skips them where there is none
(decided when the test runs, never when a module is imported).

    python -m pytest kwsbench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where torch sees none")


@pytest.fixture(autouse=True, scope="session")
def _one_torch_thread():
    """One torch thread a test process: the tiny runs' small ops would
    otherwise wait in thread barriers, several workers over the same cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return "cuda"


# tiny sizes for runs on the CPU: a narrow, shallow B0, short streams, a
# small corpus
TINY = {
    "scan-b0t3-10min": {"config": {"width_coefficient": 0.25, "depth_coefficient": 0.25, "calibration_clips": 16,
                                   "calibration_batch": 8},
                        "traffic": {"stream_s": 4, "batch_size": 64}},
    "pretrain-b0e761-b64": {"config": {"width_coefficient": 0.25, "depth_coefficient": 0.25, "num_labels": 9,
                                       "batch_size": 16},
                            "traffic": {"words": 8, "clips": 4, "steps_per_epoch": 3, "expected_clips_per_s": 10}},
    "finetune-b0t3-5shot": {"config": {"width_coefficient": 0.25, "depth_coefficient": 0.25, "calibration_clips": 16,
                                       "calibration_batch": 8},
                            "traffic": {"keywords": 4, "held_out": 2, "unknown": 8, "epochs": 2, "batch_size": 8,
                                        "traced_calls": 1}},
}
SECONDS = {"scan-b0t3-10min": 1.0, "pretrain-b0e761-b64": 1.0, "finetune-b0t3-5shot": 0.5}
