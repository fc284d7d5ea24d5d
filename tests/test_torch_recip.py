"""Port parity: K5, the approximate reciprocal (tracer_tpu_torch/ops/recip.py,
csrc/recip.cu) and its probe utils/measure_recip.py, against the JAX
package's probe benchmarks/measure_recip.py run as it is, in interpret
mode on the CPU. On the CPU the port runs the plain version
(torch.reciprocal); the kernel itself is held to it on the card (marked
requires_cuda)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tracer_tpu_torch.ops import cuda_lib, recip
from tracer_tpu_torch.utils import measure_recip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096


def test_measure_matches_the_jax_probe():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks", "measure_recip.py"),
         str(N)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = measure_recip.measure(N, device="cpu")
    assert want["interpret"] is True and got["kernel"] is False
    assert got["backend"] == "cpu" and got["n"] == want["n"] == N
    assert set(got) == set(want) - {"interpret"} | {"kernel"}
    for r in (want, got):
        assert 0 < r["max_rel"] <= recip.APPROX_RECIP_REL
        assert r["p999_rel"] <= r["max_rel"]
        assert r["log2_max"] == pytest.approx(np.log2(r["max_rel"]))
    # the plain version is torch.reciprocal: correctly rounded f32
    assert got["max_rel"] <= 2.0 ** -24


def test_inputs_are_the_jax_scripts():
    """benchmarks/measure_recip.py:36-40, bit for bit."""
    for n in (1, 1000, 1 << 20):
        rng = np.random.default_rng(7)
        x = (rng.uniform(1.0, 2.0, n) * np.exp2(rng.uniform(-20, 20, n))
             * rng.choice([-1.0, 1.0], n)).astype(np.float32)
        got = measure_recip.inputs(n)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), x.view(np.uint32))


def test_wrapper_dispatch():
    cuda_lib.reset_counts()
    x = torch.as_tensor(measure_recip.inputs(257))
    y = recip.approx_reciprocal(x)
    assert torch.equal(y, torch.reciprocal(x))
    assert torch.equal(recip.approx_reciprocal_ref(x), y)
    assert cuda_lib.plain_calls[recip.NAME] == 1
    assert sum(cuda_lib.launches.values()) == 0
    for bad in (x.double(), x.half(), x.to(torch.int32)):
        with pytest.raises(TypeError):
            recip.approx_reciprocal(bad)
    assert cuda_lib.plain_calls[recip.NAME] == 1


@pytest.mark.parametrize("view", ["odd_length", "offset"])
def test_ragged_inputs_dispatch_to_the_plain_version(view):
    """An odd length and an offset view (x[1:], not 16-byte aligned) on
    the CPU go to the plain version and equal torch.reciprocal."""
    cuda_lib.reset_counts()
    x = torch.as_tensor(measure_recip.inputs(1027))
    x = x[:1021] if view == "odd_length" else x[1:]
    y = recip.approx_reciprocal(x)
    assert y.shape == x.shape and torch.equal(y, torch.reciprocal(x))
    assert cuda_lib.plain_calls[recip.NAME] == 1
    assert sum(cuda_lib.launches.values()) == 0


def test_measure_recip_cli_on_cpu(capsys):
    measure_recip.main(["512", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip())
    assert line["n"] == 512 and line["backend"] == "cpu"
    assert line["max_rel"] <= recip.APPROX_RECIP_REL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_kernel_matches_plain_on_card(cuda_device):
    x = torch.as_tensor(measure_recip.inputs(1 << 20), device=cuda_device)
    before = cuda_lib.launches[recip.NAME]
    y = recip.approx_reciprocal(x)
    ref = recip.approx_reciprocal_ref(x)
    torch.cuda.synchronize()
    assert cuda_lib.launches[recip.NAME] == before + 1
    rel = ((y.double() - ref.double()).abs() / ref.double().abs()).max()
    assert float(rel) <= recip.RCP_APPROX_REL
    with pytest.raises(ValueError):
        recip.approx_reciprocal(x[::2])
    got = measure_recip.measure(1 << 20, device=cuda_device)
    assert got["kernel"] is True and got["max_rel"] <= recip.RCP_APPROX_REL


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["1", "3", "2^20+3", "offset"])
def test_ragged_kernel_matches_plain_on_card(case, cuda_device):
    """The kernel's scalar head and tail: lengths 1, 3 and 2^20 + 3, and
    the offset view x[1:] of 2^20 + 1 elements, within RCP_APPROX_REL of
    the plain version on every element."""
    n = {"1": 1, "3": 3, "2^20+3": (1 << 20) + 3, "offset": (1 << 20) + 1}
    x = torch.as_tensor(measure_recip.inputs(n[case]), device=cuda_device)
    if case == "offset":
        x = x[1:]
    before = cuda_lib.launches[recip.NAME]
    y = recip.approx_reciprocal(x)
    ref = recip.approx_reciprocal_ref(x)
    torch.cuda.synchronize()
    assert cuda_lib.launches[recip.NAME] == before + 1 and y.shape == x.shape
    rel = ((y.double() - ref.double()).abs() / ref.double().abs()).max()
    assert float(rel) <= recip.RCP_APPROX_REL
