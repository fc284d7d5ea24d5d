"""The benchmark's own tests: the repository's root on the path, few
threads (the tests share the host)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """Skips a test marked requires_cuda where no card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
