import pytest


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    """Point the persistent tuning cache (repro.core.tunecache) at a
    per-test directory: tests must not hit tables measured by earlier
    tests or earlier pytest runs (a stale hit would, e.g., make a
    measurement-count assertion see zero measurements).  Within one
    test, repeated tune() calls still share the cache — which is how
    the cache-hit tests exercise it."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tunecache"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run on the "
        "card with `pytest -m cuda tests/test_torch_cuda.py`")
