"""KV caches for decoder-LM serving, slot-granular and paged (counterpart
of ``hetu_tpu/serve/kv_cache.py``).

* :class:`KVCache` — the whole-sequence slot allocator: ONE pair of device
  tensors ``[L, num_slots, max_len, kv_heads, head_dim]`` and a free list
  of slots.  Every admitted sequence reserves ``max_len`` tokens whether
  it uses them or not, and identical prompts cache identical K/V twice.
* :class:`PagedKVCache` — fixed-size PAGES (``page_size`` tokens) in a
  device pool ``[L, num_pages, page_size, kv_heads, head_dim]``, per-slot
  page tables, refcounted PREFIX SHARING (sha256 of a token prefix →
  shared read-only pages) with copy-on-write on the first write into a
  shared page, and an LRU prefix index whose pages are reclaimed under
  pressure.  Its host bookkeeping is the reference's, step for step.

Both hand whole slots to admitted requests and take them back on eviction,
so finished sequences hand their memory to queued requests at once
(continuous batching, scheduler.py).

The reference's arrays are immutable and swapped wholesale after each
jitted step (donated, so XLA updates them in place).  Here the engines and
the models' cached steps write into these tensors directly.

GQA-aware: the caches store the model's ``num_kv_heads`` heads
un-repeated; ``ops.decode_attention`` and ``ops.chunk_attention`` repeat
them at read time.

Live-slot migration (serve/migrate.py) rides on ``export_slots`` /
``import_slots``: both caches lift a slot's LIVE rows into a
:class:`KVSlotSnapshot` (host tensors, one copy from the card a slot) and
write an adopted one in place, so a slot engine and a paged engine speak
one wire form.  The reference pads an import to a power-of-two row count
to bound its XLA executables; here the rows ``[:length]`` go straight into
the new slot (or its fresh pages) and nothing else moves.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class KVCacheSpec:
    """Per-layer cache geometry, derived from a model config."""

    num_layers: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32

    @staticmethod
    def from_model(model) -> "KVCacheSpec":
        """Read the geometry off a model config: configs with
        ``num_kv_heads`` are GQA (cache the un-repeated heads); the rest
        cache all ``num_heads``."""
        c = model.c
        nkv = getattr(c, "num_kv_heads", None) or c.num_heads
        return KVCacheSpec(
            num_layers=c.num_layers, num_kv_heads=nkv,
            head_dim=c.hidden_size // c.num_heads, dtype=c.dtype)


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as numpy spells it (``"float32"``, ``"bfloat16"``):
    the name migration payloads carry."""
    return str(dtype).removeprefix("torch.")


@dataclass
class KVSlotSnapshot:
    """One live cache slot lifted onto the host for migration.

    ``k``/``v`` are CPU tensors ``[num_layers, length, kv_heads,
    head_dim]`` in the source cache's dtype, truncated to the slot's live
    ``length`` (never ``max_len``: migration cost scales with what is
    cached).  Torch tensors rather than numpy arrays: numpy holds no
    bfloat16 without ``ml_dtypes``.  ``slot`` is the SOURCE slot id
    (import returns a map from it to the adopting cache's slot); ``meta``
    carries the engine's per-slot state (the last emitted token), opaque
    to the cache.
    """

    slot: int
    length: int
    k: torch.Tensor
    v: torch.Tensor
    meta: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())


def _check_snapshots(spec: KVCacheSpec, snaps, max_len: int) -> None:
    """Every snapshot must leave room to decode within ``max_len`` and
    match ``spec`` exactly (layers, kv heads, head dim, dtype): the
    validate-first half of an all-or-nothing import."""
    for s in snaps:
        if s.length < 1 or s.length >= max_len:
            raise ValueError(
                f"slot snapshot of {s.length} tokens does not leave room "
                f"to decode within max_len {max_len}")
        want = (spec.num_layers, s.length, spec.num_kv_heads, spec.head_dim)
        for name, t in (("k", s.k), ("v", s.v)):
            if tuple(t.shape) != want:
                raise ValueError(
                    f"{name} geometry mismatch: snapshot {tuple(t.shape)} "
                    f"vs cache spec {want} (layers/kv_heads/head_dim must "
                    f"match exactly)")
            if t.dtype != spec.dtype:
                raise ValueError(
                    f"{name} dtype mismatch: snapshot {dtype_name(t.dtype)} "
                    f"vs cache {dtype_name(spec.dtype)}")


def _live_length(cache, slot: int, free) -> int:
    """The cached length of an occupied ``slot``; raises for a slot out of
    range, free (in ``free``) or empty: nothing to export."""
    if not 0 <= slot < cache.num_slots:
        raise ValueError(f"slot {slot} out of range")
    if slot in free:
        raise ValueError(f"slot {slot} is free; nothing to export")
    n = int(cache.lengths[slot])
    if n < 1:
        raise ValueError(f"slot {slot} has no cached tokens")
    return n


def _to_host(k_rows, v_rows, slot: int, n: int) -> KVSlotSnapshot:
    """K and V rows of one slot, stacked on the card and fetched in ONE
    copy; the snapshot's tensors are views of that host block."""
    rows = torch.stack((k_rows, v_rows)).cpu()
    return KVSlotSnapshot(slot=slot, length=n, k=rows[0], v=rows[1])


class KVCache:
    """Slot-allocated K/V tensors + free list.

    ``k``/``v``: ``[L, num_slots, max_len, kv_heads, head_dim]`` on
    ``device``, updated in place.  ``lengths``: host-side int32 per slot —
    tokens currently cached.
    """

    def __init__(self, spec: KVCacheSpec, num_slots: int, max_len: int, *,
                 device="cuda"):
        if num_slots < 1 or max_len < 2:
            raise ValueError(f"need >=1 slot and max_len >= 2, got "
                             f"{num_slots}/{max_len}")
        self.spec = spec
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        shape = (spec.num_layers, num_slots, max_len, spec.num_kv_heads,
                 spec.head_dim)
        self.k = torch.zeros(shape, dtype=spec.dtype, device=device)
        self.v = torch.zeros(shape, dtype=spec.dtype, device=device)
        self.lengths = np.zeros(num_slots, np.int32)
        # LIFO keeps hot slots hot
        self._free = list(range(num_slots - 1, -1, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.num_slots

    @property
    def active_tokens(self) -> int:
        """Tokens currently cached across occupied slots (the scheduler's
        token-budget currency)."""
        return int(self.lengths.sum())

    def alloc(self) -> int:
        """Claim a free slot (length reset); raises if none are free —
        callers gate admission on ``num_free``."""
        if not self._free:
            raise RuntimeError("KV cache has no free slots")
        slot = self._free.pop()
        self.lengths[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        """Release a slot.  The K/V bytes are NOT zeroed — decode masks
        positions beyond ``lengths`` and prefill overwrites from position
        0, so stale rows are unreachable."""
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        self.lengths[slot] = 0
        self._free.append(slot)

    # ---- live-slot migration (serve/migrate.py rides on these) ----
    def export_slots(self, slot_ids) -> list:
        """Snapshot occupied slots for migration to a peer cache: each
        slot's rows ``[:lengths[slot]]`` fetched to the host.  The slot
        stays allocated and untouched, so a failed transfer rolls back
        by NOT freeing it."""
        snaps = []
        for slot in slot_ids:
            slot = int(slot)
            n = _live_length(self, slot, self._free)
            snaps.append(_to_host(self.k[:, slot, :n], self.v[:, slot, :n],
                                  slot, n))
        return snaps

    def import_slots(self, snapshots) -> dict:
        """Adopt peer-exported snapshots; returns ``{source_slot: slot}``.

        Validates EVERY snapshot before allocating anything, and frees
        every slot it allocated if a write fails: a mismatched migration
        errors loudly and adopts nothing.  Each snapshot's rows land in
        place in its new slot; no other slot's rows change."""
        snaps = list(snapshots)
        if len(snaps) > self.num_free:
            raise RuntimeError(f"cannot adopt {len(snaps)} slots: only "
                               f"{self.num_free} free")
        _check_snapshots(self.spec, snaps, self.max_len)
        slot_map: dict = {}
        allocated: list = []
        try:
            for s in snaps:
                slot = self.alloc()
                allocated.append(slot)
                self.k[:, slot, :s.length] = s.k
                self.v[:, slot, :s.length] = s.v
                self.lengths[slot] = s.length
                slot_map[s.slot] = slot
        except Exception:
            for slot in allocated:
                self.free(slot)
            raise
        return slot_map


def pow2_ceil(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to [1, cap]."""
    b = 1
    while b < n:
        b *= 2
    return max(min(b, cap), 1)


class PagePoolExhausted(RuntimeError):
    """A paged KV pool has no free page and nothing reclaimable.  The
    scheduler catches exactly this type to preempt a victim and requeue it
    instead of killing the engine loop."""


@dataclass
class _PrefixEntry:
    """One cached token prefix: ``pages`` hold the K/V of the first
    ``n_tokens`` tokens whose sha256 is ``key``.  An entry holds an INDEX
    reference on each page (``ref_index``); pages referenced only by the
    index are reclaimable under pressure (LRU eviction)."""

    key: bytes
    pages: tuple
    n_tokens: int


class PagedKVCache:
    """Paged K/V pool + per-slot page tables + refcounted prefix sharing.

    ``k``/``v``: ``[L, num_pages, page_size, kv_heads, head_dim]`` on
    ``device``, written in place by the engine.  Page 0 is a SCRATCH
    page: the padded rows of a chunk and a decode bucket's pad rows need a
    harmless landing zone, so page 0 is never allocated to a request.

    Ownership: each page carries two refcounts — ``ref_table`` (how many
    slot page tables reference it) and ``ref_index`` (how many prefix
    index entries do).  A slot may WRITE a page only when it is the sole
    reference (``ref_table == 1 and ref_index == 0``); a write into a
    shared page copies it first (copy-on-write, counted in
    ``cow_copies``), so indexed prefix pages are immutable and a forked
    request never corrupts its sibling's (or the index's) prefix.  A page
    returns to the (LIFO) free list when both counts reach zero; evicting
    LRU index entries under allocation pressure is what turns "referenced
    only by the index" into free pages.

    Reservations: :meth:`reserve` records an admission's worst-case page
    claim (prompt + generation + one COW), and :meth:`available_pages`
    nets free and reclaimable pages against every outstanding claim, so
    admissions cannot oversubscribe the pool under running decodes.
    """

    def __init__(self, spec: KVCacheSpec, num_slots: int, max_len: int, *,
                 page_size: int = 16, num_pages=None,
                 max_prefix_entries: int = 256, device="cuda"):
        if num_slots < 1 or max_len < 2:
            raise ValueError(f"need >=1 slot and max_len >= 2, got "
                             f"{num_slots}/{max_len}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.spec = spec
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_slot = -(-self.max_len // self.page_size)  # ceil
        if num_pages is None:
            # the slot cache's token capacity, plus the scratch page
            num_pages = 1 + self.num_slots * self.pages_per_slot
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        shape = (spec.num_layers, self.num_pages, self.page_size,
                 spec.num_kv_heads, spec.head_dim)
        self.k = torch.zeros(shape, dtype=spec.dtype, device=device)
        self.v = torch.zeros(shape, dtype=spec.dtype, device=device)
        self.lengths = np.zeros(self.num_slots, np.int32)
        self.tables: list = [[] for _ in range(self.num_slots)]
        self.ref_table = np.zeros(self.num_pages, np.int32)
        self.ref_index = np.zeros(self.num_pages, np.int32)
        self._free_slots = list(range(self.num_slots - 1, -1, -1))
        # LIFO like the slot cache: recently touched pages stay hot.
        # Page 0 is left out: the scratch page is never allocated
        self._free_pages = list(range(self.num_pages - 1, 0, -1))
        self._reserve = np.zeros(self.num_slots, np.int32)
        self.max_prefix_entries = int(max_prefix_entries)
        self._prefix: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        # host-side counters the engine mirrors into ServeMetrics
        self.cow_copies = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0

    # ---- geometry ----
    def pages_for_tokens(self, n: int) -> int:
        return -(-int(n) // self.page_size)

    @property
    def num_free(self) -> int:
        """Free REQUEST slots (the admission gate, as on KVCache)."""
        return len(self._free_slots)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free_pages)

    @property
    def reclaimable_pages(self) -> int:
        """Pages held only by the prefix index: allocatable after an LRU
        eviction, so admission counts them as available."""
        return int(np.sum((self.ref_table == 0) & (self.ref_index > 0)))

    def available_pages(self) -> int:
        """Pages an admission may still claim: free + reclaimable, net of
        every slot's outstanding reservation."""
        return (len(self._free_pages) + self.reclaimable_pages
                - int(self._reserve.sum()))

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / max(self.num_pages - 1, 1)

    # ---- slot lifecycle ----
    def alloc(self) -> int:
        if not self._free_slots:
            raise RuntimeError("paged KV cache has no free slots")
        slot = self._free_slots.pop()
        self.lengths[slot] = 0
        self.tables[slot] = []
        self._reserve[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} double-freed")
        for page in self.tables[slot]:
            self._unref_table(page)
        self.tables[slot] = []
        self.lengths[slot] = 0
        self._reserve[slot] = 0
        self._free_slots.append(slot)

    def reserve(self, slot: int, n_pages: int) -> None:
        """Record the admission's worst-case page claim for ``slot``;
        every page the slot later allocates draws it down."""
        self._reserve[slot] = max(int(n_pages), 0)

    # ---- page lifecycle (internal) ----
    def _unref_table(self, page: int) -> None:
        self.ref_table[page] -= 1
        if self.ref_table[page] < 0:
            raise AssertionError(f"page {page} table-ref underflow")
        if self.ref_table[page] == 0 and self.ref_index[page] == 0:
            self._free_pages.append(page)

    def _evict_one_entry(self) -> bool:
        """Drop the least recently used prefix entry; True if one was
        evicted (its index refs released: pages with no table refs return
        to the free list)."""
        if not self._prefix:
            return False
        _, entry = self._prefix.popitem(last=False)
        for page in entry.pages:
            self.ref_index[page] -= 1
            if self.ref_table[page] == 0 and self.ref_index[page] == 0:
                self._free_pages.append(page)
        self.prefix_evictions += 1
        return True

    def _alloc_page(self, slot: int) -> int:
        """Claim a free page for ``slot`` (evicting LRU prefix entries
        under pressure), charging its reservation."""
        while not self._free_pages:
            if not self._evict_one_entry():
                raise PagePoolExhausted(
                    "KV page pool exhausted: no free pages and nothing "
                    "reclaimable — the scheduler's page budget "
                    "under-reserved")
        page = self._free_pages.pop()
        self.ref_table[page] = 1
        self.ref_index[page] = 0
        if self._reserve[slot] > 0:
            self._reserve[slot] -= 1
        return page

    def _cow(self, slot: int, idx: int) -> int:
        """Copy-on-write: replace ``tables[slot][idx]`` (shared) with a
        private copy; the page moves on the device, every layer at once."""
        src = self.tables[slot][idx]
        dst = self._alloc_page(slot)
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]
        self.tables[slot][idx] = dst
        self._unref_table(src)
        self.cow_copies += 1
        return dst

    def prepare_write(self, slot: int, start: int, n: int):
        """Make positions ``[start, start + n)`` of ``slot`` writable:
        append fresh pages as the range grows the table, COW any shared
        page the range touches.  Returns ``(write_page, write_off)`` int32
        arrays of length ``n`` mapping each position to its physical
        (page, offset): the scatter map the engine's steps take."""
        ps = self.page_size
        if start + n > self.max_len:
            raise ValueError(f"write [{start}, {start + n}) overruns "
                             f"max_len {self.max_len}")
        table = self.tables[slot]
        pages = np.empty(n, np.int32)
        offs = np.empty(n, np.int32)
        for i in range(n):
            pos = start + i
            pi = pos // ps
            if pi == len(table):
                table.append(self._alloc_page(slot))
            elif pi > len(table):
                raise AssertionError(
                    f"write at {pos} skips pages (table has {len(table)})")
            page = table[pi]
            if self.ref_table[page] + self.ref_index[page] > 1:
                page = self._cow(slot, pi)
            pages[i] = page
            offs[i] = pos % ps
        return pages, offs

    def padded_write_map(self, pages, offs, total: int):
        """Extend a :meth:`prepare_write` map to a padded chunk bucket:
        pad positions scatter into the scratch page (0, 0)."""
        n = len(pages)
        wp = np.zeros(total, np.int32)
        wo = np.zeros(total, np.int32)
        wp[:n] = pages
        wo[:n] = offs
        return wp, wo

    def table_array(self, n_pages: int):
        """Page tables as one ``[num_slots, n_pages]`` int32 array,
        scratch-padded."""
        out = np.zeros((self.num_slots, n_pages), np.int32)
        for s, table in enumerate(self.tables):
            t = table[:n_pages]
            out[s, :len(t)] = t
        return out

    # ---- prefix sharing ----
    @staticmethod
    def _digests(tokens, page_size: int):
        """sha256 digests of every page-aligned prefix of ``tokens`` plus
        the full (possibly partial-page) prompt, computed incrementally:
        ``{n_tokens: digest}``."""
        arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
        h = hashlib.sha256()
        out = {}
        n = len(arr)
        for j in range(page_size, n + 1, page_size):
            h.update(arr[j - page_size:j].tobytes())
            out[j] = h.digest()
        if n % page_size:
            h.update(arr[(n // page_size) * page_size:].tobytes())
            out[n] = h.digest()
        return out

    def match_prefix(self, tokens, *, touch: bool = True):
        """Longest cached prefix of ``tokens``: ``(n_shared, pages)``, or
        ``(0, [])`` when nothing matches.

        Tries the exact-prompt entry first (identical prompts share even
        the partial tail page), then page-aligned prefixes, longest first.
        The match is CAPPED at ``len(tokens) - 1``: the first generated
        token needs the last prompt position's logits, so at least one
        token always prefills (into a shared page, which it then copies).
        ``touch=False`` (the admission probe) leaves the entry's LRU
        position alone: a queued request re-probing every step must not
        pin entries it has not adopted."""
        n = len(tokens)
        if n < 2 or not self.max_prefix_entries:
            return 0, []
        digests = self._digests(tokens, self.page_size)
        for cand in sorted(digests, reverse=True):
            entry = self._prefix.get(digests[cand])
            if entry is None or entry.n_tokens != cand:
                continue
            if touch:
                self._prefix.move_to_end(digests[cand])  # LRU refresh
            return min(cand, n - 1), list(entry.pages)
        return 0, []

    def adopt_prefix(self, slot: int, n_shared: int, pages) -> None:
        """Attach a matched prefix to ``slot``: its table starts as the
        shared pages (read-only: any write copies), with ``n_shared``
        tokens already valid."""
        if self.tables[slot]:
            raise ValueError(f"slot {slot} already has pages")
        self.tables[slot] = list(pages)
        for page in pages:
            self.ref_table[page] += 1
        self.lengths[slot] = int(n_shared)
        self.prefix_hit_tokens += int(n_shared)

    def register_prefix(self, slot: int, tokens, *,
                        aligned_only: bool = False) -> None:
        """Index ``slot``'s freshly prefilled prompt for later arrivals:
        one entry per page-aligned prefix plus the partial tail.
        Registered pages become IMMUTABLE (their index refs make a write
        copy them), for ``slot`` too: its first decode into a registered
        partial page copies it, leaving the indexed K/V as it was.

        ``aligned_only`` skips the partial tail: the re-index of an
        ADOPTED slot, whose tail page is still being decoded into
        (indexing it would copy that page at the next token and leave an
        entry that never matches)."""
        if not self.max_prefix_entries:
            return
        table = self.tables[slot]
        for n_tok, digest in self._digests(tokens, self.page_size).items():
            if aligned_only and n_tok % self.page_size:
                continue
            if digest in self._prefix:
                self._prefix.move_to_end(digest)
                continue
            pages = tuple(table[:self.pages_for_tokens(n_tok)])
            self._prefix[digest] = _PrefixEntry(
                key=digest, pages=pages, n_tokens=int(n_tok))
            for page in pages:
                self.ref_index[page] += 1
            while len(self._prefix) > self.max_prefix_entries:
                self._evict_one_entry()

    @property
    def prefix_entries(self) -> int:
        return len(self._prefix)

    # ---- live-slot migration (serve/migrate.py rides on these) ----
    def _rows_index(self, table, n: int) -> torch.Tensor:
        """Flat row ids (``page * page_size + offset``) of a slot's first
        ``n`` positions in the pool viewed as ``[L, pages * page_size,
        kv_heads, head_dim]``."""
        pos = np.arange(n)
        ps = self.page_size
        rows = np.asarray(table, np.int64)[pos // ps] * ps + pos % ps
        return torch.from_numpy(rows).to(self.k.device)

    def _flat(self, pool):
        return pool.view(pool.shape[0], self.num_pages * self.page_size,
                         *pool.shape[3:])

    def export_slots(self, slot_ids) -> list:
        """Snapshot occupied slots as CONTIGUOUS truncated rows, the same
        :class:`KVSlotSnapshot` wire form as the slot cache: each slot's
        LIVE pages are gathered (a shared page is read, not moved) and
        fetched to the host in one copy.  Page ids stay local; the
        adopter builds its own tables."""
        snaps = []
        for slot in slot_ids:
            slot = int(slot)
            n = _live_length(self, slot, self._free_slots)
            idx = self._rows_index(self.tables[slot], n)
            snaps.append(_to_host(self._flat(self.k)[:, idx],
                                  self._flat(self.v)[:, idx], slot, n))
        return snaps

    def import_slots(self, snapshots) -> dict:
        """Adopt peer-exported snapshots into fresh pages; returns
        ``{source_slot: slot}``.  Validates EVERYTHING (geometry, dtype,
        slot and page headroom net of every outstanding reservation)
        before allocating anything; a failed write frees every slot and
        page this call took.  The adopted slot reserves nothing: pages it
        decodes into later come from the pool (``PagePoolExhausted``
        preempts a victim when there are none)."""
        snaps = list(snapshots)
        if len(snaps) > self.num_free:
            raise RuntimeError(f"cannot adopt {len(snaps)} slots: only "
                               f"{self.num_free} free")
        _check_snapshots(self.spec, snaps, self.max_len)
        need = sum(self.pages_for_tokens(s.length) for s in snaps)
        # net of reservations: an adoption must not take the headroom a
        # running chunked prefill's admission was promised
        if need > self.available_pages():
            raise RuntimeError(
                f"cannot adopt {need} pages: only {self.available_pages()} "
                f"available (free + reclaimable - reserved)")
        slot_map: dict = {}
        allocated: list = []
        try:
            for s in snaps:
                slot = self.alloc()
                allocated.append(slot)
                table = self.tables[slot]  # free() unrefs what lands here
                for _ in range(self.pages_for_tokens(s.length)):
                    table.append(self._alloc_page(slot))
                idx = self._rows_index(table, s.length)
                self._flat(self.k)[:, idx] = s.k.to(self.k.device)
                self._flat(self.v)[:, idx] = s.v.to(self.v.device)
                self.lengths[slot] = s.length
                slot_map[s.slot] = slot
        except Exception:
            for slot in allocated:
                self.free(slot)
            raise
        return slot_map
