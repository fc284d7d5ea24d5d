"""The control (the reference with TF32 ray-triangle tests in the
program's place) reads above each cell's limit, and the program below
it: at a small size on the CPU here, at the cell's own size on a card.
On the CPU the SPD tetra scene is built at SPD_SIZE_FACTOR_ON_CPU
through a copy of the benchmark: its 262,146 triangles at size factor 8
through the plain version take far longer than a test may."""

import time

import pytest

from portbench import control, harness
from portbench import run as bench_run

BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
SPD_SIZE_FACTOR_ON_CPU = 4      # 1,026 triangles in place of 262,146


def small_cell(name, base):
    """The cell, through the copy of the benchmark at base whose SPD
    tetra generator is cut to SPD_SIZE_FACTOR_ON_CPU where the cell
    builds that scene."""
    cell = harness.Cell(BENCH, name)
    if cell.config["scene"]["generator"] != "spd_tetra":
        return cell
    gen = base / "scenes" / "spd_tetra.py"
    src = gen.read_text()
    assert "\nSIZE_FACTOR = 8\n" in src
    gen.write_text(src.replace(
        "\nSIZE_FACTOR = 8\n", f"\nSIZE_FACTOR = {SPD_SIZE_FACTOR_ON_CPU}\n"))
    return harness.Cell(harness.manifest(base.parent), name, base)


def failed_numbers(numbers):
    return [k for k, (v, lim) in numbers.items() if not v <= lim]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_small(name, bench_copy):
    cell = small_cell(name, bench_copy)
    mix = dict(cell.traffic, width=32, height=24,
               spp=min(int(cell.traffic["spp"]), 16))
    settings = dict(cell.check, pixels=64)
    r = bench_run.run_cell(cell, 2_718_281_828, 0.0, False, "cpu",
                           time.perf_counter(), "cpu", mix, settings)
    assert r["correct"], r["checks"]
    nums = control.readings(cell, 2_718_281_828, 2, 12, "cpu", mix, settings)
    assert failed_numbers(nums), nums


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name, cuda):
    cell = harness.Cell(BENCH, name)
    for seed in (3_300_000_001, 3_300_000_002, 3_300_000_003):
        nums = control.readings(cell, seed, 14, 80, cuda)
        assert failed_numbers(nums), (seed, nums)
