"""The benchmark's own tests: the repository's root on the path, few
threads (the tests share the host)."""

import json
import shutil
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


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark at tmp_path/portbench beside a copy of
    BENCHMARK.json, for a test that plants files in it: the copied
    folder, to pass as a Cell's base."""
    from portbench import harness
    base = tmp_path / "portbench"
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(harness.manifest()))
    return base
