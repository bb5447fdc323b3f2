"""``kernels/build.py`` names each library by what its build reads: the
source, every header of ``csrc/`` and the flags.  Nothing is compiled
here (no nvcc on the CPU); only the names are computed."""
from __future__ import annotations

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_unchanged_sources_keep_their_library(csrc):
    assert build.library_path("a") == build.library_path("a")
    assert build.library_path("a").name.startswith("a-")


@pytest.mark.parametrize("edit", ["source", "header", "new_header"])
def test_an_edit_renames_the_library(csrc, edit):
    before = build.library_path("a")
    if edit == "source":
        (csrc / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    elif edit == "header":
        (csrc / "h.cuh").write_text("// v2\n")
    else:
        (csrc / "g.cuh").write_text("// new\n")
    assert build.library_path("a") != before


def test_flags_are_part_of_the_name(csrc, monkeypatch):
    before = build.library_path("a")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("a") != before


def test_a_reused_library_reports_its_build_log(csrc, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    build.BUILD_DIR.mkdir()
    build.library_path("a").write_bytes(b"")       # already built
    assert build.build_all(["a"]) == {"a": ""}     # built before logs were kept
    build.log_path("a").write_text("ptxas info: Used 90 registers\n")
    assert build.build_all(["a"]) == {"a": "ptxas info: Used 90 registers\n"}
    assert build.log_path("a").parent == build.library_path("a").parent
