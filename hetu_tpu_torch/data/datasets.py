"""CIFAR-10 and MNIST as numpy arrays (counterpart of
``hetu_tpu/data/datasets.py``, numpy only, copied).

The loaders read local files when present (``HETU_TPU_DATA_DIR``, default
``~/.hetu_tpu/data``, the reference's lookup) and otherwise fall back to
the reference's deterministic synthetic data with the real shapes, bitwise
the same arrays: enough for throughput and pipeline tests, while accuracy
runs need the real files in the data directory in the standard
numpy/pickle layouts.  The synthetic labels are random, so the learning
signal there is memorisation of a repeated subset.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np


def _data_dir() -> Path:
    return Path(os.environ.get("HETU_TPU_DATA_DIR",
                               Path.home() / ".hetu_tpu" / "data"))


def _synthetic(shape_x, shape_y, num_classes, seed=1234):
    g = np.random.default_rng(seed)
    x = g.standard_normal(shape_x, dtype=np.float32)
    y = g.integers(0, num_classes, size=shape_y).astype(np.int32)
    return x, y


def cifar10(normalize: bool = True, synthetic_n: int = 10000):
    """Returns (train_x NCHW, train_y, test_x, test_y)."""
    d = _data_dir() / "cifar-10-batches-py"
    if d.exists():
        xs, ys = [], []
        for i in range(1, 6):
            with open(d / f"data_batch_{i}", "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            xs.append(batch[b"data"])
            ys.append(batch[b"labels"])
        train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32)
        train_y = np.concatenate(ys).astype(np.int32)
        with open(d / "test_batch", "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        test_x = batch[b"data"].reshape(-1, 3, 32, 32).astype(np.float32)
        test_y = np.asarray(batch[b"labels"], np.int32)
        if normalize:
            mean = train_x.mean(axis=(0, 2, 3), keepdims=True)
            std = train_x.std(axis=(0, 2, 3), keepdims=True)
            train_x = (train_x - mean) / std
            test_x = (test_x - mean) / std
        return train_x, train_y, test_x, test_y
    n = synthetic_n
    train_x, train_y = _synthetic((n, 3, 32, 32), (n,), 10, seed=1234)
    test_x, test_y = _synthetic((n // 5, 3, 32, 32), (n // 5,), 10, seed=5678)
    return train_x, train_y, test_x, test_y


def mnist(normalize: bool = True, synthetic_n: int = 10000):
    """Returns (train_x [N,784], train_y, test_x, test_y)."""
    d = _data_dir() / "mnist"
    if (d / "mnist.npz").exists():
        z = np.load(d / "mnist.npz")
        train_x = z["x_train"].reshape(-1, 784).astype(np.float32)
        train_y = z["y_train"].astype(np.int32)
        test_x = z["x_test"].reshape(-1, 784).astype(np.float32)
        test_y = z["y_test"].astype(np.int32)
        if normalize:
            train_x /= 255.0
            test_x /= 255.0
        return train_x, train_y, test_x, test_y
    n = synthetic_n
    train_x, train_y = _synthetic((n, 784), (n,), 10, seed=42)
    test_x, test_y = _synthetic((n // 5, 784), (n // 5,), 10, seed=43)
    return train_x, train_y, test_x, test_y
