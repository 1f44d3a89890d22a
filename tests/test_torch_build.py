"""The build key of the port's CUDA sources: a library's name hashes its
source, the csrc/ headers that source includes (and only those) and the
flags, so an edit to a header rebuilds the sources that include it and no
other.  Runs without nvcc: nothing here compiles."""
import pytest

from srcgan_tpu_torch.ops.kernels import build


@pytest.mark.parametrize("name, included", [
    ("tail_x4", ["hopper.cuh"]),
    ("probes", ["hopper.cuh"]),
    ("tail_x4_wmma", []),
    ("rdb5", []),
    ("ssim", []),
    ("gray_degrade", []),
])
def test_headers_are_those_the_source_includes(name, included):
    src = (build.CSRC / f"{name}.cu").read_bytes()
    assert [p.name for p in build.headers(src)] == included


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#include <cstdint>\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n  #  include "a.cuh"\n')
    (tmp_path / "c.cuh").write_text("#pragma once\n")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include "a.cuh"\n#include "missing.cuh"\n')
    (tmp_path / "plain.cu").write_text("#include <cuda_runtime.h>\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_headers_follow_includes_once_each(csrc):
    assert [p.name for p in build.headers((csrc / "k.cu").read_bytes())] == ["a.cuh", "b.cuh"]
    assert build.headers((csrc / "plain.cu").read_bytes()) == []


@pytest.mark.parametrize("edited, rebuilds", [
    ("b.cuh", {"k"}),          # reached through a.cuh
    ("c.cuh", set()),          # included by no source
    ("k.cu", {"k"}),
    ("plain.cu", {"plain"}),
])
def test_an_edit_changes_the_keys_of_the_sources_that_reach_it(csrc, edited, rebuilds):
    before = {n: build.library_path(n) for n in ("k", "plain")}
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in ("k", "plain")}
    assert {n for n in before if before[n] != after[n]} == rebuilds


def test_defines_make_a_library_of_their_own(csrc):
    assert build.library_path("k") != build.library_path("k", ("X=1",))
    assert build.library_path("k", ("X=1",)) == build.library_path("k", ("X=1",))
