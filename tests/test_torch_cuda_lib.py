"""ops/cuda_lib.py, the one seam between the port and its hand kernels:
every host entry point of csrc/ in the one form, every kernel a wrapper
counts known there, the operand check, the launch, its count and its
recording (with a stand-in for the library: no card here)."""

from __future__ import annotations

import re
import types
from pathlib import Path

import pytest
import torch

from tracer_tpu_torch.engine import interaction, refill, shade
from tracer_tpu_torch.ops import bvh, cuda_lib, recip
from tracer_tpu_torch.ops import intersect_kernel as ik

PKG = Path(cuda_lib.__file__).resolve().parents[1]
SIGNATURE = ("const void* const* ptr, const long long* in, int n_ptr, "
             "int n_int, void* stream")


def _host_functions(source: str) -> dict:
    """{name: argument list} of the functions of the extern "C" block."""
    block = source.split('extern "C" {', 1)[1].split('}  // extern "C"')[0]
    return {m.group(1): " ".join(m.group(2).split())
            for m in re.finditer(r"^(?:static )?int (\w+)\(([^)]*)\)", block,
                                 re.M)}


def _entries() -> dict:
    return {name: args for path in cuda_lib.sources()
            for name, args in _host_functions(path.read_text()).items()}


@pytest.mark.parametrize("source", [p.name for p in cuda_lib.sources()])
def test_every_launch_entry_has_the_one_form(source):
    """Each <name>_launch of a csrc source takes (ptr, in, n_ptr, n_int,
    stream) and checks its arity; every other exported function is an
    int getter of no argument."""
    text = (cuda_lib.CSRC / source).read_text()
    funcs = _host_functions(text)
    launches = {k: v for k, v in funcs.items() if k.endswith("_launch")}
    assert launches, source
    for name, args in launches.items():
        assert args == SIGNATURE, (source, name, args)
        body = text.split(f"int {name}(", 1)[1].split("\n}\n", 1)[0]
        assert "n_ptr" in body.split(")", 1)[1], (source, name)
    for name, args in funcs.items():
        if name not in launches and name != "query_walk":
            assert args == "", (source, name, args)


def test_every_counted_kernel_is_one_cuda_lib_knows():
    """The wrappers' kernel names are cuda_lib.KERNELS, each with an entry
    point (K2 and K4 through closest_hit_launch and any_hit_launch); every
    name a module of the package launches or counts as plain is one of
    them; every constant a wrapper registers has its getter in csrc/."""
    wrappers = (*ik.KERNELS, *ik.PREP_KERNELS, *shade.KERNELS,
                *refill.KERNELS, *bvh.KERNELS, *interaction.KERNELS,
                recip.NAME)
    assert sorted(wrappers) == sorted(cuda_lib.KERNELS)
    assert cuda_lib.launches.keys() == cuda_lib.plain_calls.keys() == set(
        cuda_lib.KERNELS)
    entries = _entries()
    for name in cuda_lib.KERNELS:
        base = name.removesuffix("_streamed")
        assert f"{base}_launch" in entries, name
    used = set()
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        used |= set(re.findall(r'cuda_lib\.(?:launch|plain)\(\s*"(\w+)"',
                               text))
    assert used and used <= set(cuda_lib.KERNELS), used
    assert cuda_lib._expected and all(
        entries.get(g) == "" for g in cuda_lib._expected), cuda_lib._expected
    assert cuda_lib._expected["kernel_block"] == ik.BLOCK
    assert cuda_lib._expected["shade_block"] == shade.BLOCK
    assert cuda_lib._expected["prep_max_sched"] == ik.MAX_SCHED


def test_a_constant_is_checked_against_the_library(monkeypatch):
    """expect() holds the library's getter to the wrapper's value, at
    load or at once when the library is loaded already."""
    monkeypatch.setattr(cuda_lib, "_expected", {})
    monkeypatch.setattr(cuda_lib._Built, "lib",
                        types.SimpleNamespace(shade_block=lambda: 128))
    cuda_lib.expect(shade_block=128)
    with pytest.raises(RuntimeError, match="shade_block"):
        cuda_lib.expect(shade_block=64)


def test_operand_checks_device_dtype_shape_and_layout():
    x = torch.zeros((3, 8))
    cpu = torch.device("cpu")
    assert cuda_lib.operand(x, cpu, shape=(3, 8)) is x
    for kw in ({"dtype": torch.int32}, {"shape": (8, 3)},
               {"device": torch.device("meta")}):
        args = {"device": cpu, **kw}
        with pytest.raises(ValueError, match="want"):
            cuda_lib.operand(x, **args)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lib.operand(x.T, cpu)
    assert cuda_lib.operand(x.T, cpu, strided=True) is not None
    lane = torch.zeros(()).expand(8)
    assert cuda_lib.operand(lane, cpu, shape=(8,), strided=True) is lane


def test_launch_passes_counts_records_and_raises(monkeypatch):
    """launch() hands the entry point the pointers (null for None) and
    the int64s with their counts, counts the launch under its name, and
    records it: a recorded launch calls the entry again, uncounted. A
    nonzero return raises."""
    seen, result = [], [0]

    def entry(ptr, ints, n_ptr, n_int, stream):
        seen.append(([ptr[i] for i in range(n_ptr)],
                     [ints[i] for i in range(n_int)], stream.value))
        return result[0]

    monkeypatch.setattr(cuda_lib, "load",
                        lambda: types.SimpleNamespace(superchunk_launch=entry))
    monkeypatch.setattr(cuda_lib, "raw_stream", lambda index: 7)
    cuda_lib.reset_counts()
    a, b = torch.zeros(4), torch.zeros(2, dtype=torch.int64)
    with cuda_lib.recording() as calls:
        cuda_lib.launch("superchunk", a.device, [a, None, b], [3, -1, 2**40])
    assert seen == [([a.data_ptr(), None, b.data_ptr()], [3, -1, 2**40], 7)]
    assert cuda_lib.launches["superchunk"] == 1
    assert [c.name for c in calls] == ["superchunk"]
    calls[0]()
    assert len(seen) == 2 and seen[1] == seen[0]
    assert cuda_lib.launches["superchunk"] == 1
    result[0] = 700
    with pytest.raises(RuntimeError, match="superchunk_kernel.*700"):
        cuda_lib.launch("superchunk", a.device, [a], [1])
    assert cuda_lib.launches["superchunk"] == 1
    cuda_lib.plain("superchunk")
    assert cuda_lib.plain_calls["superchunk"] == 1
    cuda_lib.reset_counts()
    assert sum(cuda_lib.launches.values()) == sum(
        cuda_lib.plain_calls.values()) == 0
