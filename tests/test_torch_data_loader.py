"""The port's token loaders (``data/loader.py``) against the JAX package's,
on the CPU, over a token file the test writes.

- the port's native loader (``native/tokenloader.cc`` built by g++ into
  the port's ``_build/``) and its Python loader against the JAX package's
  native and Python loaders: the same batches, exactly, for each (seed,
  shard of shards, threads, start_batch) and for the synthetic stream;
- ``make_loader`` takes the native loader where g++ builds it;
- a token outside the vocab raises in both port loaders, with the JAX
  message;
- ``device_batches`` yields int32 tensors of the loader's batches;
- ``train_main --data``: a second life resumed at step 2 reads the
  stream's batches 2 and 3, the ones a run of four steps would.
"""

import numpy as np
import pytest
import torch

from k8s_runpod_kubelet_tpu.data import loader as jloader
from k8s_runpod_kubelet_tpu_torch import data as pdata
from k8s_runpod_kubelet_tpu_torch.data import loader as ploader
from k8s_runpod_kubelet_tpu_torch.workloads import train_main

SEQ, BATCH = 16, 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "tokens.bin"
    rng = np.random.default_rng(17)
    rng.integers(0, 256, 5000).astype("<i4").tofile(path)
    return str(path)


def _stream(cls, path, n, **kw):
    with cls(path, SEQ, BATCH, vocab_size=256, **kw) as loader:
        return [loader.next() for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=7, threads=3), dict(seed=7, threads=1),
    dict(seed=5, shard_id=1, num_shards=3, threads=2),
    dict(seed=5, start_batch=4), dict(seed=2, shard_id=2, num_shards=3,
                                      start_batch=2, threads=4)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_the_port_loaders_yield_the_jax_batches(corpus, kw):
    want = _stream(jloader.PyTokenLoader, corpus, 5, **kw)
    for cls in (ploader.NativeTokenLoader, ploader.PyTokenLoader,
                jloader.NativeTokenLoader):
        got = _stream(cls, corpus, 5, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=cls.__module__)


def test_the_synthetic_streams_match_too():
    want = _stream(jloader.PyTokenLoader, None, 3, seed=9)
    for cls in (ploader.NativeTokenLoader, ploader.PyTokenLoader):
        for a, b in zip(_stream(cls, None, 3, seed=9), want):
            np.testing.assert_array_equal(a, b)


def test_make_loader_takes_the_native_loader(corpus):
    with ploader.make_loader(corpus, SEQ, BATCH, vocab_size=256) as loader:
        assert isinstance(loader, ploader.NativeTokenLoader)
    built = ploader._build_native()
    assert built.parent == ploader.BUILD_DIR and built.exists()
    assert built.parent.parent.name == "k8s_runpod_kubelet_tpu_torch"


def test_out_of_range_tokens_raise(corpus):
    for port, jax_cls in ((ploader.NativeTokenLoader,
                           jloader.NativeTokenLoader),
                          (ploader.PyTokenLoader, jloader.PyTokenLoader)):
        msgs = []
        for cls in (port, jax_cls):
            with cls(corpus, SEQ, BATCH, vocab_size=100) as loader:
                with pytest.raises(ValueError, match="outside model vocab") \
                        as err:
                    loader.next()
                msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_device_batches_yields_int32_tensors(corpus):
    loader = ploader.PyTokenLoader(corpus, SEQ, BATCH, vocab_size=256)
    want = _stream(ploader.PyTokenLoader, corpus, 2)
    it = ploader.device_batches(loader, "cpu")
    for b in want:
        t = next(it)
        assert t.dtype == torch.int32 and t.shape == (BATCH, SEQ + 1)
        np.testing.assert_array_equal(t.numpy(), b)


def test_train_main_data_resumes_at_the_right_batch(corpus, tmp_path,
                                                    monkeypatch):
    seen = []
    real = pdata.device_batches

    def recording(loader, device=None):
        for t in real(loader, device):
            seen.append(t.clone())
            yield t

    monkeypatch.setattr(pdata, "device_batches", recording)
    argv = ["--device", "cpu", "--model", "tiny", "--steps", "2",
            "--batch", str(BATCH), "--seq-len", str(SEQ), "--data", corpus,
            "--checkpoint-dir", str(tmp_path / "ck")]
    assert train_main.main(argv) == 0
    assert train_main.main(argv) == 0
    # two batches a life: the second life's are the stream's batches 2, 3
    want = _stream(jloader.PyTokenLoader, corpus, 4)
    assert len(seen) == 4
    for t, b in zip(seen, want):
        np.testing.assert_array_equal(t.numpy(), b)
