"""The kernel build's cache key and the CUDA sources' includes, on the CPU.

``bigdl_tpu_torch.ops._build`` names each library by a hash of its ``.cu``
source, every shared header ``csrc/*.cuh`` and the ``nvcc`` flags, so an
edited header rebuilds every source instead of loading a stale library.
Nothing here needs ``nvcc``: ``_target`` only reads files.
"""

import re
from pathlib import Path

import pytest

from bigdl_tpu_torch.ops import _build

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"


@pytest.fixture
def src_dir(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "h.cuh"\n__global__ void k() {}\n')
    (src / "h.cuh").write_text("#pragma once\n// v1\n")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    return src


def test_target_changes_with_the_header_and_not_with_other_files(src_dir):
    first = _build._target("k")
    assert first == _build._target("k")  # a fixed key
    (src_dir / "notes.txt").write_text("unrelated\n")
    (src_dir / "other.cu").write_text("__global__ void other() {}\n")
    assert _build._target("k") == first
    (src_dir / "h.cuh").write_text("#pragma once\n// v2\n")
    second = _build._target("k")
    assert second != first and second.parent == first.parent
    assert second.name.startswith("libk-") and second.suffix == ".so"
    (src_dir / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second)


def test_target_covers_every_header(src_dir):
    first = _build._target("k")
    (src_dir / "z.cuh").write_text("#pragma once\n")
    assert _build._target("k") != first


def test_a_built_library_is_reused_with_its_ptxas_report(src_dir):
    lib = _build._target("k")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    lib.with_suffix(".ptxas.txt").write_text("ptxas info    : Used 8 registers\n")
    assert _build._start("k") is None  # nothing to build, no nvcc needed
    assert "Used 8 registers" in _build.BUILD_LOGS["k"]


def test_every_quoted_include_names_a_file_in_csrc():
    sources = sorted(CSRC.glob("*.cu"))
    assert {s.stem for s in sources} == set(_build.KERNELS)
    found = []
    for src in sources:
        for name in re.findall(r'^\s*#include\s+"([^"]+)"', src.read_text(),
                               re.MULTILINE):
            found.append(name)
            assert (CSRC / name).is_file(), f"{src.name} includes {name}"
    assert "mma_bf16.cuh" in found
