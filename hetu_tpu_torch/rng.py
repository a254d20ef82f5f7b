"""Checkpointable global RNG with (seed, seqnum) semantics (counterpart of
``hetu_tpu/rng.py``).

A global seed plus a sequence number that only grows; every consumer
derives an independent stream from (seed, seqnum), so a checkpoint that
records the pair resumes the same streams.  Where the reference folds the
pair into a JAX PRNG key, the port seeds a ``torch.Generator`` on the
device that will draw from it.  The two frameworks give different numbers
from the same pair.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class _RngState:
    seed: int = 0
    seqnum: int = 0


_state = _RngState()
_lock = threading.Lock()


def derive_seed(*words: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` that depends on
    every word (non-negative ints), through numpy's ``SeedSequence``."""
    hi, lo = np.random.SeedSequence([int(w) for w in words]).generate_state(
        2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def set_random_seed(seed: int) -> None:
    """Set the global seed and reset the sequence number."""
    with _lock:
        _state.seed = int(seed)
        _state.seqnum = 0


def get_seed_status() -> tuple[int, int]:
    """Return (seed, seqnum) for checkpointing."""
    return _state.seed, _state.seqnum


def set_seed_status(seed: int, seqnum: int) -> None:
    """Restore (seed, seqnum) from a checkpoint."""
    with _lock:
        _state.seed = int(seed)
        _state.seqnum = int(seqnum)


def step_seqnum(n: int = 1) -> int:
    """Advance the sequence number."""
    with _lock:
        _state.seqnum += n
        return _state.seqnum


def next_generator(device="cuda") -> torch.Generator:
    """A generator on ``device`` seeded from (seed, seqnum); advances
    seqnum (the reference's ``next_key``)."""
    with _lock:
        seed = derive_seed(_state.seed, _state.seqnum)
        _state.seqnum += 1
    return torch.Generator(device=device).manual_seed(seed)


def np_rng() -> np.random.Generator:
    """Reproducible numpy Generator derived from (seed, seqnum); advances
    seqnum."""
    with _lock:
        g = np.random.default_rng((_state.seed, _state.seqnum))
        _state.seqnum += 1
    return g
