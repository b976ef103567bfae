import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _bench_env(tmp_path, monkeypatch):
    """The port's tune cache in the test's own directory, few threads."""
    import torch
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
