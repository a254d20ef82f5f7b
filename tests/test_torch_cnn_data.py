"""The CNN slice's data path of hetu_tpu_torch against hetu_tpu, on the
CPU: ``datasets.cifar10()`` and ``mnist()`` (the synthetic fallback and the
local files), the ``Dataloader``'s shuffled order under one
``set_random_seed``, its ``prefetch``, rank and part slicing, and
``ElasticBatchSchedule``.  Everything here is numpy, so every comparison
is bitwise."""

import pickle

import numpy as np
import pytest

from hetu_tpu import rng as jrng
from hetu_tpu.data import dataloader as jloader
from hetu_tpu.data import datasets as jdatasets
from hetu_tpu_torch import rng as trng
from hetu_tpu_torch.data import (
    Dataloader, ElasticBatchSchedule, datasets,
)


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


@pytest.mark.parametrize("name", ["cifar10", "mnist"])
def test_synthetic_fallback_is_the_references(name, tmp_path, monkeypatch):
    monkeypatch.setenv("HETU_TPU_DATA_DIR", str(tmp_path))  # no files
    got = getattr(datasets, name)(synthetic_n=200)
    _same(got, getattr(jdatasets, name)(synthetic_n=200))
    assert got[0].shape == ((200, 3, 32, 32) if name == "cifar10"
                            else (200, 784))
    assert got[2].shape[0] == 40


def test_local_files_load_as_the_references(tmp_path, monkeypatch):
    """The real-file branches, on small files in the standard layouts."""
    g = np.random.default_rng(0)
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": g.integers(0, 256, (4, 3072), np.uint8),
                         b"labels": list(g.integers(0, 10, 4))}, f)
    (tmp_path / "mnist").mkdir()
    np.savez(tmp_path / "mnist" / "mnist.npz",
             x_train=g.integers(0, 256, (6, 28, 28), np.uint8),
             y_train=g.integers(0, 10, 6),
             x_test=g.integers(0, 256, (3, 28, 28), np.uint8),
             y_test=g.integers(0, 10, 3))
    monkeypatch.setenv("HETU_TPU_DATA_DIR", str(tmp_path))
    for normalize in (True, False):
        _same(datasets.cifar10(normalize), jdatasets.cifar10(normalize))
        _same(datasets.mnist(normalize), jdatasets.mnist(normalize))
    assert datasets.cifar10()[0].shape == (20, 3, 32, 32)


def _epochs(loader_cls, data, seed, n=2, **kw):
    """Two epochs of batches, the global stream seeded ``seed``."""
    (jrng if loader_cls is jloader.Dataloader else trng).set_random_seed(
        seed)
    loader = loader_cls(data, **kw)
    return [b for _ in range(n) for b in loader]


@pytest.mark.parametrize("kw", [
    dict(batch_size=7, shuffle=True),
    dict(batch_size=7, shuffle=True, drop_last=False),
    dict(batch_size=5, shuffle=False)])
def test_dataloader_order_is_the_references(kw):
    g = np.random.default_rng(1)
    data = (g.standard_normal((40, 3)), g.integers(0, 10, 40))
    got = _epochs(Dataloader, data, 3, **kw)
    ref = _epochs(jloader.Dataloader, data, 3, **kw)
    assert len(got) == len(ref)
    for (gx, gy), (rx, ry) in zip(got, ref):
        assert np.array_equal(gx, rx) and np.array_equal(gy, ry)
    assert len(Dataloader(data, **kw)) == len(jloader.Dataloader(data, **kw))


def test_prefetch_yields_the_iterations_batches():
    x = np.arange(60).reshape(30, 2)
    trng.set_random_seed(4)
    plain = list(Dataloader(x, 4, shuffle=True))
    trng.set_random_seed(4)
    fetched = list(Dataloader(x, 4, shuffle=True).prefetch(depth=2))
    jrng.set_random_seed(4)
    ref = list(jloader.Dataloader(x, 4, shuffle=True))
    assert len(plain) == len(fetched) == len(ref) == 7
    for a, b, c in zip(plain, fetched, ref):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_prefetch_raises_the_producers_error():
    class Broken(Dataloader):
        def __iter__(self):
            yield self.arrays[0][:2]
            raise RuntimeError("bad batch")
    with pytest.raises(RuntimeError, match="bad batch"):
        list(Broken(np.zeros((4, 2)), 2).prefetch())


def test_rank_and_part_slicing_is_the_references():
    x = np.arange(24 * 6).reshape(24, 6)
    for cls in (Dataloader, jloader.Dataloader):
        loader = cls(x, 3)
        loader.set_dp_rank(1, 2)
        loader.set_mp_parts({1: 1}, {1: 3})
        if cls is Dataloader:
            got = list(loader)
        else:
            ref = list(loader)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    assert np.array_equal(got[0], x[12:15, 2:4])


def test_elastic_batch_schedule_is_the_references():
    data = (np.arange(50), np.arange(50) * 2)
    got = ElasticBatchSchedule(data, 12, seed=5)
    ref = jloader.ElasticBatchSchedule(data, 12, seed=5)
    for step in range(9):  # into the third epoch
        for a, b in zip(got.global_batch(step), ref.global_batch(step)):
            assert np.array_equal(a, b)
        for rank in range(3):
            for a, b in zip(got.local_slice(step, rank, 3),
                            ref.local_slice(step, rank, 3)):
                assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="divisible"):
        got.check_width(5)
