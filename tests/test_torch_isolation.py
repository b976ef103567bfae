"""The port stands alone: importing all of ``repro_torch`` (its models and
its serving engine included) pulls in neither JAX nor any module of the
reference package, and where there is no CUDA card its device entry
points (the backend, ``execute``, ``Transformer.init`` and ``init_cache``,
``ServeRuntime``, ``launch.serve``, ``launch.train``, the prefetch
iterator and the offloaded optimizer's state placement) raise instead of
running on the CPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "repro"
                or m.startswith("repro."))
assert not leaked, leaked
assert len(names) >= 20, names
assert "repro_torch.models.moe" in names, names
for name in ("repro_torch.launch.train", "repro_torch.launch.steps",
             "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
             "repro_torch.runtime.fault", "repro_torch.optim.adamw",
             "repro_torch.optim.adafactor"):
    assert name in names, name

import torch
from repro_torch.configs import get_config, reduced
from repro_torch.core import TorchDeviceBackend, execute, get_backend, plan
from repro_torch.models import Transformer
from repro_torch.polybench import build
from repro_torch.launch.serve import main as serve_main
from repro_torch.serve import ServeRuntime
from repro_torch.data import PrefetchIterator, SyntheticLM
from repro_torch.launch.train import main as train_main, train
from repro_torch.optim import adamw, offloaded_state
cfg = reduced(get_config("rwkv6-3b"))
src = SyntheticLM(cfg, 1, 8)
model = Transformer(cfg, use_pallas=True)
if torch.cuda.is_available():
    assert get_backend(None).device.type == "cuda"
    params = model.init(torch.Generator("cuda"))
    assert params["embed"].device.type == "cuda"
    assert ServeRuntime(cfg, max_seq=16).device.type == "cuda"
else:
    for make in (TorchDeviceBackend, lambda: get_backend(None),
                 lambda: execute(plan(build("3mm", n=8)[0])),
                 lambda: model.init(torch.Generator()),
                 lambda: model.init_cache(1, 8),
                 lambda: ServeRuntime(cfg, max_seq=16),
                 lambda: serve_main(["--arch", "rwkv6-3b", "--reduced"]),
                 lambda: serve_main(["--arch", "rwkv6-3b", "--reduced",
                                     "--engine"]),
                 lambda: train(cfg, steps=1, batch=1, seq=8,
                               ckpt_dir="unused"),
                 lambda: train_main(["--arch", "rwkv6-3b", "--reduced",
                                     "--ckpt-dir", "unused"]),
                 lambda: PrefetchIterator(src),
                 lambda: offloaded_state(adamw().init(
                     model.abstract_params()))):
        try:
            make()
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("a cuda backend was built without a card")
print("isolated", len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_reference():
    res = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("isolated")


def test_no_import_of_jax_or_reference_in_sources():
    pattern = re.compile(r"^\s*(import|from) (jax|repro)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        assert not pattern.search(f.read_text()), f


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    """Without a card, or copied away from the repo, chip_smoke.py exits
    non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    else:
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present: chip_smoke.py runs for real")
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env={k: v for k, v in _env().items()
                              if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
