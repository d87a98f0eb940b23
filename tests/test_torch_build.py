"""PyTorch port: the kernel build's cache key covers the shared headers.

`kernels/_build.library_path` names each library after a hash of its
`csrc/<name>.cu`, of every `csrc/*.cuh` and of the nvcc flags, so that
editing a header rebuilds every library that may include it. Runs on a
copy of `csrc/` under tmp_path; needs no nvcc.
"""
import shutil

import pytest

from ultrafnd_git_tpu_torch.kernels import _build

KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "adamw")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _paths():
    return {name: _build.library_path(name) for name in KERNELS}


def test_sources_ship_the_shared_header():
    assert (_build.CSRC / "tf32_mma.cuh").exists()
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert '#include "tf32_mma.cuh"' in (_build.CSRC / f"{name}.cu").read_text()


def test_library_path_is_stable_and_under_the_build_dir(csrc):
    first = _paths()
    assert first == _paths()
    for name, path in first.items():
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "_")


def test_header_edit_changes_every_library_path(csrc):
    before = _paths()
    header = csrc / "tf32_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    assert all(after[name] != before[name] for name in KERNELS)


def test_new_header_or_source_edit_changes_the_path(csrc):
    before = _paths()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_new = _paths()
    assert all(with_new[name] != before[name] for name in KERNELS)
    src = csrc / "adamw.cu"
    src.write_text(src.read_text() + "\n")
    edited = _paths()
    assert edited["adamw"] != with_new["adamw"]
    assert all(edited[n] == with_new[n] for n in KERNELS if n != "adamw")
