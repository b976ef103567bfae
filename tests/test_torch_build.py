"""The kernel build's digest: ``_build.digest`` covers everything ``nvcc``
reads (the source, every ``csrc/*.cuh`` header, the global flags, a
kernel's extra flags), so a change to any of them names a new build
directory and rebuilds, and nothing else does.  No ``nvcc`` is needed."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint k;\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    (tmp_path / "other.cu").write_text("int other;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_digest_is_stable(csrc):
    assert _build.digest("k") == _build.digest("k")
    assert _build.digest("k", ("-lcuda",)) == _build.digest("k", ("-lcuda",))
    # another kernel's source is not read
    before = _build.digest("k")
    (csrc / "other.cu").write_text("int other2;\n")
    assert _build.digest("k") == before


@pytest.mark.parametrize("change", ["source", "header", "new_header"])
def test_digest_follows_what_nvcc_reads(csrc, change):
    before = _build.digest("k")
    if change == "source":
        (csrc / "k.cu").write_text('#include "h.cuh"\nint k2;\n')
    elif change == "header":
        (csrc / "h.cuh").write_text("#pragma once\n#define X 1\n")
    else:
        (csrc / "g.cuh").write_text("#pragma once\n")
    assert _build.digest("k") != before


def test_digest_follows_flags(csrc, monkeypatch):
    base = _build.digest("k")
    assert _build.digest("k", ("-lcuda",)) != base
    assert _build.digest("k", ("-lcuda",)) != _build.digest("k", ("-ldl",))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.digest("k") != base

