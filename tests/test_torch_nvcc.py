"""The port's kernel builder, without building anything: a library's
file name covers its flags and every file beside its source."""

from __future__ import annotations

from repro_torch.kernels.nvcc import BASE_FLAGS, Library


def _library(tmp_path):
    csrc = tmp_path / "pkg" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("#define WIDTH 64\n")
    return csrc, Library(csrc / "k.cu", BASE_FLAGS, lambda lib: None)


def test_editing_a_header_beside_the_source_changes_the_library(tmp_path):
    csrc, lib = _library(tmp_path)
    before = lib.path()
    assert before.parent == tmp_path / "pkg" / "_build"
    assert before.name.startswith("libk_") and before.suffix == ".so"
    assert lib.path() == before
    (csrc / "k.cuh").write_text("#define WIDTH 128\n")
    assert lib.path() != before


def test_adding_a_file_or_changing_flags_changes_the_library(tmp_path):
    csrc, lib = _library(tmp_path)
    before = lib.path()
    (csrc / "extra.cuh").write_text("// new\n")
    added = lib.path()
    assert added != before
    other = Library(csrc / "k.cu", BASE_FLAGS + ("-lineinfo",),
                    lambda lib: None)
    assert other.path() != added
    assert not (tmp_path / "pkg" / "_build").exists()  # nothing was built


def test_editing_a_header_in_a_dependency_changes_the_library(tmp_path):
    """A source that includes another kernel package's headers names that
    package's ``csrc/`` in ``deps``; editing a header there rebuilds."""
    csrc, _ = _library(tmp_path)
    other = tmp_path / "other" / "csrc"
    other.mkdir(parents=True)
    (other / "shared.cuh").write_text("#define DEPTH 4\n")
    lib = Library(csrc / "k.cu", BASE_FLAGS, lambda lib: None, deps=(other,))
    before = lib.path()
    assert before != Library(csrc / "k.cu", BASE_FLAGS,
                             lambda lib: None).path()
    (other / "shared.cuh").write_text("#define DEPTH 8\n")
    assert lib.path() != before
