"""Batching dataloader with DP-rank and MP-part slicing (counterpart of
``hetu_tpu/data/dataloader.py``, numpy only, copied).

``Dataloader`` slices the dataset per data-parallel rank (``set_dp_rank``)
and per model-parallel part (``set_mp_parts``), shuffles with the port's
global (seed, seqnum) stream (:func:`hetu_tpu_torch.rng.np_rng`, the same
numpy generator as the reference's, so one ``set_random_seed`` gives the
same order in both packages) and yields numpy minibatches; the Executor
moves them to the card.  ``ElasticBatchSchedule`` fixes the global batch
sequence across resizes.

The module loads ``torch`` (through the rng) only when a ``Dataloader``
shuffles: the elastic training plane's worker processes build their
``ElasticBatchSchedule`` without it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class Dataloader:
    def __init__(self, data, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = True, dtype=np.float32):
        """data: one array or a tuple/list of arrays with equal leading dim."""
        self.arrays = [np.asarray(a) for a in
                       (data if isinstance(data, (tuple, list)) else [data])]
        n = self.arrays[0].shape[0]
        assert all(a.shape[0] == n for a in self.arrays)
        self.n_total = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.dp_rank: Optional[int] = None
        self.dp_nrank: Optional[int] = None
        self.parts = None
        self._single = not isinstance(data, (tuple, list))

    # ---- distributed slicing (reference dataloader.py:202-260) ----
    def set_dp_rank(self, dp_rank: int, dp_nrank: int):
        """Keep only this data-parallel rank's shard (contiguous block)."""
        self.dp_rank, self.dp_nrank = dp_rank, dp_nrank

    def set_mp_parts(self, part_idx, parts):
        """Model-parallel input splitting (reference :210): `parts` maps
        dims to split counts, part_idx the index per dim."""
        self.parts = (part_idx, parts)

    def _local_arrays(self):
        arrs = self.arrays
        if self.dp_rank is not None:
            per = self.n_total // self.dp_nrank
            lo = self.dp_rank * per
            hi = lo + per
            arrs = [a[lo:hi] for a in arrs]
        if self.parts is not None:
            part_idx, parts = self.parts
            out = []
            for a in arrs:
                for dim, cnt in parts.items():
                    size = a.shape[dim] // cnt
                    idx = [slice(None)] * a.ndim
                    idx[dim] = slice(part_idx[dim] * size,
                                     (part_idx[dim] + 1) * size)
                    a = a[tuple(idx)]
                out.append(a)
            arrs = out
        return arrs

    @property
    def num_batches(self) -> int:
        n = self._local_arrays()[0].shape[0]
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    # alias matching the reference's get_num_step naming
    get_batch_num = num_batches

    def __iter__(self):
        arrs = self._local_arrays()
        n = arrs[0].shape[0]
        order = np.arange(n)
        if self.shuffle:
            from hetu_tpu_torch import rng as hrng
            hrng.np_rng().shuffle(order)
        nb = self.num_batches
        for b in range(nb):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch = [a[sel] for a in arrs]
            yield batch[0] if self._single else tuple(batch)

    def prefetch(self, depth: int = 2):
        """Iterate with a background thread keeping `depth` batches ready —
        host batch assembly overlaps the device step (the reference's
        dataloader worker, dataloader.py batching thread).

        Producer exceptions re-raise in the consumer; abandoning the
        generator early (break / close) stops and joins the producer.
        """
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=depth)
        DONE = object()
        stop = threading.Event()

        def producer():
            try:
                for batch in self:
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # forward into the consumer
                try:
                    q.put(e, timeout=1.0)
                except queue.Full:
                    pass
                return
            finally:
                if not stop.is_set():
                    try:
                        q.put(DONE, timeout=1.0)
                    except queue.Full:
                        pass

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)

    def __len__(self):
        return self.num_batches


class ElasticBatchSchedule:
    """A WIDTH-INVARIANT global batch schedule for elastic training.

    The plain :class:`Dataloader` shards the DATASET per dp rank up front
    (``set_dp_rank``), which bakes the fleet width into the epoch: after an
    elastic resize the ranks' shards, the shuffle order, and therefore the
    training trajectory all change.  This schedule fixes the GLOBAL batch
    sequence instead — ``global_batch(step)`` is a pure function of
    ``(seed, step)``, independent of how many workers exist — and resizes
    only change how each global batch is SLICED across the survivors
    (``local_slice``).  A 4-wide run that shrinks to 3 and regrows to 4
    consumes byte-identical global batches in the same order as a run that
    never resized, which is what makes the elastic chaos test's
    final-params comparison meaningful (and is the ``set_mp_parts``-style
    re-partition the reference dataloader applies per rank).

    ``batch_size`` is the GLOBAL batch and must stay divisible by every
    width the run can shrink to — validate widths up front with
    :meth:`check_width` (the elastic supervisor does).
    """

    def __init__(self, data, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True):
        self.arrays = [np.asarray(a) for a in
                       (data if isinstance(data, (tuple, list)) else [data])]
        self._single = not isinstance(data, (tuple, list))
        n = self.arrays[0].shape[0]
        if any(a.shape[0] != n for a in self.arrays):
            raise ValueError("arrays must share the leading dim")
        if not 0 < batch_size <= n:
            raise ValueError(f"global batch {batch_size} vs {n} rows")
        self.n_total = n
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.batches_per_epoch = n // self.batch_size
        self._order_cache: tuple = (-1, None)  # (epoch, permutation)

    def check_width(self, dp: int) -> None:
        if dp <= 0 or self.batch_size % dp != 0:
            raise ValueError(
                f"global batch {self.batch_size} is not divisible by "
                f"dp={dp}; an elastic run must pick a global batch "
                "divisible by every width it can shrink to (e.g. a "
                "multiple of lcm(1..nominal_dp))")

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self._order_cache[0] == epoch:
            return self._order_cache[1]
        order = np.arange(self.n_total)
        if self.shuffle:
            # seeded per (seed, epoch) — NOT the framework RNG stream, so
            # the schedule replays identically regardless of what else
            # consumed randomness (retries, resizes, chaos)
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        # memoized per epoch: a full O(n) shuffle per STEP would dominate
        # small steps on big datasets (every step calls global_indices)
        self._order_cache = (epoch, order)
        return order

    def global_indices(self, step: int) -> np.ndarray:
        epoch, b = divmod(int(step), self.batches_per_epoch)
        order = self._epoch_order(epoch)
        return order[b * self.batch_size:(b + 1) * self.batch_size]

    def global_batch(self, step: int):
        """The step's full global batch — single-controller callers feed
        this straight to the executor."""
        sel = self.global_indices(step)
        batch = [a[sel] for a in self.arrays]
        return batch[0] if self._single else tuple(batch)

    def local_slice(self, step: int, rank: int, dp: int):
        """Worker ``rank``-of-``dp``'s contiguous slice of the step's
        global batch (the multi-controller re-partition): after a resize,
        calling with the new ``(rank, dp)`` redistributes the SAME global
        batch over the survivors."""
        self.check_width(dp)
        if not 0 <= rank < dp:
            raise ValueError(f"rank {rank} not in [0, {dp})")
        sel = self.global_indices(step)
        per = self.batch_size // dp
        sel = sel[rank * per:(rank + 1) * per]
        batch = [a[sel] for a in self.arrays]
        return batch[0] if self._single else tuple(batch)
