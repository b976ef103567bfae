"""The port's data pipeline against the reference's
(``src/repro/data/pipeline.py``): ``SyntheticLM`` gives the same arrays,
key for key, for tokens, embeds and codebook labels; ``PrefetchIterator``
keeps order, cursor and restore on the host (``device="cpu"``; the card's
streams are held in ``tests/test_torch_cuda.py``)."""
import time

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.data import SyntheticLM as RefSyntheticLM
from repro_torch.configs import get_config, reduced
from repro_torch.data import PrefetchIterator, SyntheticLM

ARCHS = ("internlm2-20b", "musicgen-large", "qwen3-moe-30b-a3b",
         "rwkv6-3b")


@pytest.mark.parametrize("index", [0, 1, 7, 1234])
@pytest.mark.parametrize("name", ARCHS)
def test_batches_equal_reference(name, index):
    ref = RefSyntheticLM(ref_reduced(ref_get_config(name)), batch=3, seq=24,
                         seed=5)
    port = SyntheticLM(reduced(get_config(name)), batch=3, seq=24, seed=5)
    want, got = ref.batch_at(index), port.batch_at(index)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


def test_musicgen_embeds_and_codebook_labels():
    cfg = reduced(get_config("musicgen-large"))
    b = SyntheticLM(cfg, batch=2, seq=8, seed=1).batch_at(0)
    assert sorted(b) == ["embeds", "labels"]
    assert b["embeds"].shape == (2, 8, cfg.d_model)
    assert b["embeds"].dtype == np.float32
    assert b["labels"].shape == (2, 8, cfg.n_codebooks)


def test_labels_are_next_tokens():
    src = SyntheticLM(reduced(get_config("internlm2-20b")), batch=2, seq=32)
    b = src.batch_at(0)
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()


def test_prefetch_iterator_order_and_state():
    src = SyntheticLM(reduced(get_config("internlm2-20b")), batch=2, seq=8,
                      seed=1)
    it = PrefetchIterator(src, start_index=0, device="cpu")
    try:
        b0, b1 = next(it), next(it)
        state = it.state_dict()
    finally:
        it.close()
    assert state == {"index": 2}
    for got, i in ((b0, 0), (b1, 1)):
        want = src.batch_at(i)
        assert sorted(got) == sorted(want)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    it2 = PrefetchIterator.restore(src, state, device="cpu")
    try:
        b2 = next(it2)
        assert it2.state_dict() == {"index": 3}
    finally:
        it2.close()
    np.testing.assert_array_equal(b2["tokens"].numpy(),
                                  src.batch_at(2)["tokens"])


def test_prefetch_iterator_runs_ahead_and_closes():
    """The producer fills ``depth`` batches ahead without being asked, and
    ``close`` stops its thread."""
    src = SyntheticLM(reduced(get_config("internlm2-20b")), batch=1, seq=4)
    it = PrefetchIterator(src, start_index=3, depth=2, device="cpu")
    try:
        for _ in range(200):
            if it._q.full():
                break
            time.sleep(0.01)
        assert it._q.full()
        assert it.index == 3
        np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                      src.batch_at(3)["tokens"])
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_prefetch_iterator_default_device_is_the_card():
    src = SyntheticLM(reduced(get_config("internlm2-20b")), batch=1, seq=4)
    if torch.cuda.is_available():
        it = PrefetchIterator(src)
        try:
            assert next(it)["tokens"].device.type == "cuda"
        finally:
            it.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PrefetchIterator(src)
