"""Bucketed prefill + single-token decode over the model forwards
(counterpart of ``hetu_tpu/serve/engine.py``).

Two engines share one serving surface: :class:`ServeEngine` over the slot
cache, and :class:`PagedServeEngine` over the paged pool (page tables,
prefix sharing, chunked prefill; see kv_cache.py).

Prompts are right-padded to power-of-two BUCKETS (plus the cache's
``max_len`` as the last bucket), exactly as in the reference: the numbers
then equal the reference's (the same padded shapes), and the set of prefill
shapes stays bounded by ``len(buckets)`` — what a later CUDA-graph capture
needs.  ``prefill_compiles`` counts the buckets seen (PyTorch compiles
nothing; the metric keeps its reference name).  The paged engine's
counterpart: power-of-two chunk buckets for prefill, power-of-two
active-batch x page-count buckets for decode
(:meth:`PagedServeEngine.compiled_executables`).

The slot engine prefills one request at a time (batch 1) and decodes ALL
cache slots at once with fixed shapes (``[num_slots]`` tokens/lengths), so
continuous batching admissions never change the decode shape.  Free slots
ride along masked.

Both engines run under ``torch.inference_mode()`` on a copy of the model
whose matmul weights were cast to the compute type ONCE, when the engine
was built (:meth:`GPTModel.inference_copy`).  Both export, resume and
adopt live slots for migration (serve/migrate.py): an adopted slot decodes
on where its source stopped, with no prefill.  The reference's tensor
parallel ``mesh`` waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hetu_tpu_torch.serve.kv_cache import (
    KVCache, KVCacheSpec, PagedKVCache, pow2_ceil,
)
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.telemetry import trace


def _pow2_buckets(lo: int, hi: int) -> tuple:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


class ServeEngine:
    """Owns the serving copy of the model, the KV cache and the steps.

    model: a ``GPTModel`` (anything with ``inference_copy`` /
    ``prefill_with_cache`` / ``decode_with_cache``).  num_slots bounds
    concurrent sequences; max_len bounds tokens per sequence (prompt +
    generation), defaulting to the model's max_position.  The engine runs
    on ``device`` (the card unless the caller asks for the CPU).
    """

    def __init__(self, model, *, num_slots: int = 8,
                 max_len: Optional[int] = None, min_bucket: int = 16,
                 metrics: Optional[ServeMetrics] = None, device="cuda"):
        self.metrics = metrics or ServeMetrics()
        c = model.c
        max_len = int(max_len or c.max_position)
        if max_len > c.max_position:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"max_position {c.max_position}")
        self.device = torch.device(device)
        self.model = model.inference_copy().to(self.device)
        self.buckets = _pow2_buckets(min(min_bucket, max_len), max_len)
        self.cache = KVCache(KVCacheSpec.from_model(model), num_slots,
                             max_len, device=self.device)
        # newest token per slot (decode feeds all slots every step)
        self.last_tokens = np.zeros(num_slots, np.int32)
        self.active = np.zeros(num_slots, bool)
        self._seen_buckets = set()
        self._decoded = False

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds max_len "
                         f"{self.cache.max_len}")

    def _tensor(self, array):
        return torch.tensor(array, dtype=torch.int64, device=self.device)

    # ---- serving steps ----
    def prefill(self, slot: int, prompt_ids) -> int:
        """Run the prompt through the bucketed prefill into ``slot``;
        returns the first generated (greedy) token."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = prompt.shape[0]
        if n < 1:
            raise ValueError("empty prompt")
        if n >= self.cache.max_len:
            raise ValueError(f"prompt of {n} tokens leaves no room to "
                             f"generate within max_len {self.cache.max_len}")
        s = self.bucket_for(n)
        if s not in self._seen_buckets:
            self._seen_buckets.add(s)
            self.metrics.inc("prefill_compiles")
            trace.instant("serve.recompile",
                          {"kind": "prefill", "bucket": s})
        with trace.span("serve.prefill") as sp, torch.inference_mode():
            sp.set("slot", int(slot))
            sp.set("tokens", n)
            sp.set("bucket", s)
            ids = np.zeros((1, s), np.int32)
            ids[0, :n] = prompt
            # last_index: only the final real position's logits are
            # computed — the padded tail's head matmul is skipped
            logits, k, v = self.model.prefill_with_cache(
                self._tensor(ids), last_index=n - 1)
            # k: [L, 1, S, nkv, hd] — batch 1 IS the slot's row
            self.cache.k[:, slot, :s] = k[:, 0]
            self.cache.v[:, slot, :s] = v[:, 0]
            # the host fetch is the sync point: inside the span, so the
            # span covers device execution, not just the launches
            first = int(torch.argmax(logits[0]))
        self.cache.lengths[slot] = n
        self.last_tokens[slot] = first
        self.active[slot] = True
        self.metrics.inc("prefill_tokens", n)
        return first

    def decode(self) -> dict:
        """One decode step over every slot; returns {slot: token} for the
        active ones.  Inactive slots compute masked garbage (the shapes
        stay fixed) and are ignored."""
        if not self.active.any():
            return {}
        if (self.cache.lengths[self.active] >= self.cache.max_len).any():
            raise RuntimeError(
                "an active slot is at max_len; the scheduler must evict "
                "before decoding further")
        if not self._decoded:
            self._decoded = True
            self.metrics.inc("decode_compiles")
            trace.instant("serve.recompile", {"kind": "decode"})
        with trace.span("serve.decode") as sp, torch.inference_mode():
            if trace.enabled():  # the reduction is attr-only: skip when off
                sp.set("active", int(self.active.sum()))
            logits, _, _ = self.model.decode_with_cache(
                self._tensor(self.last_tokens), self.cache.k, self.cache.v,
                self._tensor(self.cache.lengths))
            # host fetch = the sync point; inside the span (see prefill)
            nxt = torch.argmax(logits, -1).cpu().numpy()
        out = {}
        for slot in np.nonzero(self.active)[0]:
            self.cache.lengths[slot] += 1
            self.last_tokens[slot] = nxt[slot]
            out[int(slot)] = int(nxt[slot])
        self.metrics.inc("decode_steps")
        self.metrics.observe_decode(len(out))
        return out

    # ---- live-slot migration ----
    def export_slots(self, slot_ids) -> list:
        """Snapshot mid-decode slots for hand-off to a peer engine: the
        cache's truncated rows plus this engine's per-slot decode state
        in ``meta`` (the last emitted token, which is NOT in the cache
        yet): all a peer needs to decode on with zero prefill.

        The exported slots are SUSPENDED (allocated, but skipped by
        :meth:`decode`) until the caller releases them (the migration
        committed) or :meth:`resume_slots` them (rollback); a decode step
        in between would advance them past their requests' recorded
        tokens.  Suspension comes last, after every snapshot was taken,
        so a failed export leaves every slot decoding."""
        return _export_slots(self, slot_ids)

    def resume_slots(self, slot_ids) -> None:
        """Re-activate slots suspended by :meth:`export_slots`, the
        rollback of a failed migration: they decode on exactly where they
        stopped (``last_tokens`` was kept).  All or nothing."""
        _resume_slots(self, slot_ids)

    def adopt_slots(self, snapshots) -> dict:
        """Adopt peer-exported slots; returns ``{source_slot: slot}``.
        The next :meth:`decode` continues each adopted sequence where the
        source left off: no prefill runs for it (``prefill_tokens`` stays
        flat)."""
        return _adopt_slots(self, snapshots)

    # ---- slot lifecycle (delegates; engine keeps its masks in sync) ----
    def alloc_slot(self) -> int:
        slot = self.cache.alloc()
        self.active[slot] = False
        return slot

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self.last_tokens[slot] = 0
        self.cache.free(slot)


def _export_slots(engine, slot_ids) -> list:
    for slot in slot_ids:
        if not engine.active[int(slot)]:
            raise ValueError(f"slot {int(slot)} is not mid-decode; nothing "
                             f"to migrate")
    # the fetch to the host ends the span: it covers the device copies
    with trace.span("serve.export_slots") as sp:
        snaps = engine.cache.export_slots(slot_ids)
        sp.set("slots", len(snaps))
        sp.set("bytes", sum(x.nbytes for x in snaps))
    for s in snaps:
        s.meta["last_token"] = int(engine.last_tokens[s.slot])
    for slot in slot_ids:  # suspend LAST: a failure above leaves every
        engine.active[int(slot)] = False  # slot decoding
    return snaps


def _resume_slots(engine, slot_ids) -> None:
    slots = [int(s) for s in slot_ids]
    for slot in slots:  # validate first: resume is all-or-nothing
        if engine.cache.lengths[slot] < 1:
            raise ValueError(f"slot {slot} has no cached tokens to resume")
    for slot in slots:
        engine.active[slot] = True


def _adopt_slots(engine, snapshots) -> dict:
    snaps = list(snapshots)
    for s in snaps:
        if "last_token" not in s.meta:
            raise ValueError(f"slot snapshot {s.slot} has no last_token "
                             f"meta: exported from a cache, not an engine?")
    with trace.span("serve.adopt_slots") as sp:
        slot_map = engine.cache.import_slots(snaps)
        sp.set("slots", len(snaps))
        sp.set("bytes", sum(x.nbytes for x in snaps))
    for s in snaps:
        slot = slot_map[s.slot]
        engine.last_tokens[slot] = int(s.meta["last_token"])
        engine.active[slot] = True
    engine.metrics.inc("slots_adopted", len(slot_map))
    return slot_map


class _PrefillCursor:
    """Host-side state of one chunked prefill in progress."""

    __slots__ = ("prompt", "pos", "n", "max_tokens", "matched")

    def __init__(self, prompt: np.ndarray, max_tokens: int):
        self.prompt = prompt
        self.pos = 0             # next position to prefill
        self.n = int(prompt.shape[0])
        self.max_tokens = int(max_tokens)
        self.matched = False     # the prefix match ran (first chunk)

    @property
    def done(self) -> bool:
        return self.pos >= self.n


def _pow2_count(n: int) -> int:
    """How many powers of two ``pow2_ceil`` can return below cap ``n``."""
    count, b = 1, 1
    while b < n:
        b *= 2
        count += 1
    return count


class PagedServeEngine:
    """ServeEngine over a :class:`PagedKVCache`: chunked prefill, paged
    gather/scatter decode, prefix sharing with copy-on-write.

    A drop-in for :class:`ServeEngine` under the scheduler (the same
    ``prefill``/``decode``/``alloc_slot``/``release`` surface and
    ``cache.lengths``/``max_len``/``num_free`` geometry), plus what the
    scheduler's page-budget admission and chunked-prefill interleave use:
    :meth:`admission_ok`, :meth:`begin_prefill`, :meth:`prefill_step`.

    Both steps gather a slot's pages into a contiguous view, run the
    model's cached step on it, and write back only the rows the step
    produced.  The view is a COPY (``k[:, table]`` is advanced indexing),
    so the rows go back through a host-built write map (``k[:, page, off]
    = rows``); pad positions land in scratch page 0.  The chunk path
    gathers the slot's whole table (``pages_per_slot`` pages); a padded
    final chunk near ``max_len`` runs past that view, and there the view
    is extended by one chunk of scratch columns so that nothing clamps
    (a clamped start would smear pad rows over real history).  Decode
    gathers only the ACTIVE slots, as a power-of-two batch bucket over a
    power-of-two page bucket, so its work follows live traffic.

    ``compiled_executables``/``max_executables`` count the shapes seen, as
    the slot engine's ``prefill_compiles`` does: the bounded set a later
    CUDA-graph capture needs.
    """

    def __init__(self, model, *, num_slots: int = 8,
                 max_len: Optional[int] = None, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, min_bucket: int = 16,
                 prefix_sharing: bool = True, max_prefix_entries: int = 256,
                 metrics: Optional[ServeMetrics] = None, device="cuda"):
        self.metrics = metrics or ServeMetrics()
        c = model.c
        max_len = int(max_len or c.max_position)
        if max_len > c.max_position:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"max_position {c.max_position}")
        self.device = torch.device(device)
        self.model = model.inference_copy().to(self.device)
        self.cache = PagedKVCache(
            KVCacheSpec.from_model(model), num_slots, max_len,
            page_size=page_size, num_pages=num_pages,
            max_prefix_entries=max_prefix_entries if prefix_sharing else 0,
            device=self.device)
        # chunk ends align to prefill_chunk boundaries (a multiple of
        # page_size), so chunks fill whole pages and the prefix index's
        # page-aligned entries match cleanly
        if prefill_chunk is None:
            prefill_chunk = max(4 * page_size, min_bucket)
        ps = self.cache.page_size
        self.prefill_chunk = -(-int(prefill_chunk) // ps) * ps
        self.chunk_buckets = _pow2_buckets(
            min(min_bucket, self.prefill_chunk), self.prefill_chunk)
        self.last_tokens = np.zeros(num_slots, np.int32)
        self.active = np.zeros(num_slots, bool)
        self._cursors: dict = {}  # slot -> _PrefillCursor
        self._seen_chunk_buckets = set()  # (bucket, view pages)
        self._seen_page_buckets = set()   # (batch bucket, page bucket)

    # ---- shape accounting ----
    def compiled_executables(self) -> int:
        """Step shapes seen so far (the reference's jit-cache count)."""
        return len(self._seen_chunk_buckets) + len(self._seen_page_buckets)

    @property
    def max_executables(self) -> int:
        """One per chunk bucket per view (whole table, extended boundary
        view) + one per (pow2 active batch, pow2 page count) pair."""
        return (2 * len(self.chunk_buckets)
                + _pow2_count(self.cache.pages_per_slot)
                * _pow2_count(self.cache.num_slots))

    def chunk_bucket_for(self, n: int) -> int:
        for b in self.chunk_buckets:
            if n <= b:
                return b
        raise ValueError(f"chunk of {n} tokens exceeds prefill_chunk "
                         f"{self.prefill_chunk}")

    def _view(self, pool, tables):
        """The pages of ``tables`` ``[B, n]`` as a contiguous (copied)
        ``[L, B, n * page_size, kv_heads, head_dim]`` view."""
        b, n = tables.shape
        return pool[:, tables].reshape(pool.shape[0], b,
                                       n * self.cache.page_size,
                                       *pool.shape[3:])

    # ---- admission (the scheduler's page-budget backpressure) ----
    def admission_pages(self, prompt_len: int, max_tokens: int,
                        shared_tokens: int = 0) -> int:
        """Worst-case pages an admission can touch: prompt + generation
        (capped at max_len) minus the already-shared pages, plus one page
        of copy-on-write headroom."""
        total = min(int(prompt_len) + int(max_tokens) + 1,
                    self.cache.max_len)
        return max(self.cache.pages_for_tokens(total)
                   - self.cache.pages_for_tokens(int(shared_tokens)), 0) + 1

    def admission_ok(self, prompt, max_tokens: int) -> bool:
        """True when the pool can hold this request's worst case beside
        every outstanding reservation.  Prefix-shared pages are credited,
        but the prefix is probed (LRU-neutrally) only when the worst case
        does not fit without the credit."""
        avail = self.cache.available_pages()
        if self.admission_pages(len(prompt), max_tokens, 0) <= avail:
            return True
        n_shared, _ = self.cache.match_prefix(prompt, touch=False)
        if not n_shared:
            return False
        return self.admission_pages(len(prompt), max_tokens,
                                    n_shared) <= avail

    # ---- chunked prefill ----
    def begin_prefill(self, slot: int, prompt_ids, *,
                      max_tokens: int = 0) -> None:
        """Start a chunked prefill into ``slot``: reserve the worst-case
        page budget and park a cursor for :meth:`prefill_step`.  The
        prefix match runs on the FIRST chunk, not here, so a request
        admitted beside an identical one still shares whenever the
        earlier one's prefill completes (and registers) first.  The slot
        stays inactive until the final chunk emits the first token."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = prompt.shape[0]
        if n < 1:
            raise ValueError("empty prompt")
        if n >= self.cache.max_len:
            raise ValueError(f"prompt of {n} tokens leaves no room to "
                             f"generate within max_len {self.cache.max_len}")
        self.cache.reserve(slot, self.admission_pages(n, max_tokens, 0))
        self._cursors[slot] = _PrefillCursor(prompt, max_tokens)
        self.active[slot] = False

    def _match_on_first_chunk(self, slot: int, cur: _PrefillCursor) -> None:
        cur.matched = True
        n_shared, pages = self.cache.match_prefix(cur.prompt)
        if n_shared and not self.cache.tables[slot]:
            self.cache.adopt_prefix(slot, n_shared, pages)
            cur.pos = n_shared
            # shrink the admission's reservation by the shared credit
            self.cache.reserve(slot, self.admission_pages(
                cur.n, cur.max_tokens, n_shared))
            self.metrics.inc("prefix_hits")
            self.metrics.inc("prefix_hit_tokens", n_shared)
            trace.instant("serve.prefix_hit",
                          {"slot": int(slot), "tokens": int(n_shared)})
        self.metrics.inc("prefix_miss_tokens", cur.n - cur.pos)

    def prefill_step(self, slot: int) -> Optional[int]:
        """Run the next page-aligned chunk of ``slot``'s prefill.  Returns
        the first generated (greedy) token when the final chunk completes
        (the slot then decodes), else None."""
        cur = self._cursors.get(slot)
        if cur is None:
            raise ValueError(f"slot {slot} has no prefill in progress")
        if not cur.matched:
            self._match_on_first_chunk(slot, cur)
        cache = self.cache
        start = cur.pos
        end = min(cur.n, (start // self.prefill_chunk + 1)
                  * self.prefill_chunk)
        size = end - start
        s = self.chunk_bucket_for(size)
        ps = cache.page_size
        n_table = cache.pages_per_slot
        if start + s > n_table * ps:
            # the PADDED window [start, start + s) runs past the slot's
            # own view: extend it by one chunk of scratch columns
            n_table += -(-self.prefill_chunk // ps)
        if (s, n_table) not in self._seen_chunk_buckets:
            self._seen_chunk_buckets.add((s, n_table))
            self.metrics.inc("prefill_compiles")
            trace.instant("serve.recompile",
                          {"kind": "prefill_chunk", "bucket": s})
        cow0 = cache.cow_copies
        wp, wo = cache.prepare_write(slot, start, size)
        wp, wo = cache.padded_write_map(wp, wo, s)
        # the chunk's host operands (ids | write pages | write offsets |
        # page table) in one upload, as the reference packs them
        aux = np.zeros(3 * s + n_table, np.int64)
        aux[:size] = cur.prompt[start:end]
        aux[s:2 * s] = wp
        aux[2 * s:3 * s] = wo
        t = cache.tables[slot]
        aux[3 * s:3 * s + len(t)] = t
        with trace.span("serve.prefill_chunk") as sp, \
                torch.inference_mode():
            sp.set("slot", int(slot))
            sp.set("start", int(start))
            sp.set("tokens", int(size))
            sp.set("bucket", int(s))
            dev = torch.from_numpy(aux).to(self.device)
            ids, wpage, woff = dev[:s][None], dev[s:2 * s], dev[2 * s:3 * s]
            table = dev[3 * s:][None]
            k_seq = self._view(cache.k, table)
            v_seq = self._view(cache.v, table)
            logits, k_seq, v_seq = self.model.prefill_chunk_with_cache(
                ids, k_seq, v_seq, start, last_index=size - 1)
            # every row of the padded chunk goes back through the write
            # map: real positions to their pages, pad positions to scratch
            cache.k[:, wpage, woff] = k_seq[:, 0, start:start + s]
            cache.v[:, wpage, woff] = v_seq[:, 0, start:start + s]
            # the host fetch is the sync point, inside the span
            tok = int(torch.argmax(logits[0]))
        cache.lengths[slot] = end
        cur.pos = end
        self.metrics.inc("prefill_tokens", size)
        self.metrics.inc("prefill_chunks")
        if cache.cow_copies > cow0:
            self.metrics.inc("cow_copies", cache.cow_copies - cow0)
        if not cur.done:
            return None
        del self._cursors[slot]
        cache.register_prefix(slot, cur.prompt)
        self.last_tokens[slot] = tok
        self.active[slot] = True
        return tok

    def prefill(self, slot: int, prompt_ids) -> int:
        """Whole-prompt prefill (the slot engine's surface): begin, then
        run every chunk in one call."""
        self.begin_prefill(slot, prompt_ids)
        while True:
            tok = self.prefill_step(slot)
            if tok is not None:
                return tok

    # ---- decode ----
    def decode(self) -> dict:
        """One decode step over the ACTIVE slots; returns {slot: token}.

        The step gathers a power-of-two bucket of active slots over a
        power-of-two bucket of pages.  Pad rows of the batch bucket repeat
        slot 0's table (a harmless gather) but write to the scratch page,
        so they never touch the pool."""
        cache = self.cache
        act = np.nonzero(self.active)[0]
        if len(act) == 0:
            return {}
        if (cache.lengths[act] >= cache.max_len).any():
            raise RuntimeError(
                "an active slot is at max_len; the scheduler must evict "
                "before decoding further")
        cow0 = cache.cow_copies
        bb = pow2_ceil(len(act), cache.num_slots)
        sl = np.zeros(bb, np.int64)
        sl[:len(act)] = act
        # grow or copy each active slot's write target BEFORE the step
        wp = np.zeros(bb, np.int64)
        wo = np.zeros(bb, np.int64)
        for i, slot in enumerate(act):
            p, o = cache.prepare_write(int(slot), int(cache.lengths[slot]),
                                       1)
            wp[i], wo[i] = p[0], o[0]
        # the page bucket covers the ACTIVE slots only: a long prompt
        # still prefilling must not widen every interleaved decode
        n_pg = pow2_ceil(max(len(cache.tables[int(s)]) for s in act),
                         cache.pages_per_slot)
        if (bb, n_pg) not in self._seen_page_buckets:
            self._seen_page_buckets.add((bb, n_pg))
            self.metrics.inc("decode_compiles")
            trace.instant("serve.recompile",
                          {"kind": "decode", "pages": int(n_pg),
                           "batch": int(bb)})
        # every host operand of the step (page table | length | token |
        # write page | write offset) in one upload
        aux = np.zeros((bb, n_pg + 4), np.int64)
        for i, slot in enumerate(sl):
            t = cache.tables[slot][:n_pg]
            aux[i, :len(t)] = t
        aux[:, n_pg] = cache.lengths[sl]
        aux[:, n_pg + 1] = self.last_tokens[sl]
        aux[:, n_pg + 2] = wp
        aux[:, n_pg + 3] = wo
        with trace.span("serve.decode") as sp, torch.inference_mode():
            if trace.enabled():
                sp.set("active", int(len(act)))
                sp.set("pages", int(n_pg))
            dev = torch.from_numpy(aux).to(self.device)
            lengths = dev[:, n_pg]
            k_seq = self._view(cache.k, dev[:, :n_pg])
            v_seq = self._view(cache.v, dev[:, :n_pg])
            logits, k_seq, v_seq = self.model.decode_with_cache(
                dev[:, n_pg + 1], k_seq, v_seq, lengths)
            # only each row's new token goes back to the pool, never the
            # gathered view.  A pad row's length may lie past its view
            # (its own writes clamp there too); it lands in scratch
            rows = torch.arange(bb, device=self.device)
            at = lengths.clamp(max=k_seq.shape[2] - 1)
            wpage, woff = dev[:, n_pg + 2], dev[:, n_pg + 3]
            cache.k[:, wpage, woff] = k_seq[:, rows, at]
            cache.v[:, wpage, woff] = v_seq[:, rows, at]
            nxt = torch.argmax(logits, -1).cpu().numpy()  # the sync point
        out = {}
        for i, slot in enumerate(act):
            cache.lengths[slot] += 1
            self.last_tokens[slot] = nxt[i]
            out[int(slot)] = int(nxt[i])
        if cache.cow_copies > cow0:
            self.metrics.inc("cow_copies", cache.cow_copies - cow0)
        self.metrics.inc("decode_steps")
        self.metrics.observe_decode(len(out))
        self.metrics.set_gauge("pages_in_use", cache.pages_in_use)
        self.metrics.set_gauge("prefix_entries", cache.prefix_entries)
        return out

    # ---- live-slot migration (the slot engine's contract) ----
    def export_slots(self, slot_ids) -> list:
        """As :meth:`ServeEngine.export_slots`; a slot whose chunked
        prefill is still running is not mid-decode (the scheduler
        exports its request as queued)."""
        return _export_slots(self, slot_ids)

    def resume_slots(self, slot_ids) -> None:
        _resume_slots(self, slot_ids)

    def adopt_slots(self, snapshots) -> dict:
        """As :meth:`ServeEngine.adopt_slots`: the rows land in fresh
        pages of this pool."""
        return _adopt_slots(self, snapshots)

    def reindex_prefix(self, slot: int, tokens) -> None:
        """Re-dedup an ADOPTED slot into this engine's prefix index:
        register the page-boundary hashes of ``tokens`` (the slot's token
        stream, which the scheduler knows; the cache holds only rows)
        against the imported pages, so later traffic that shares the
        migrated prompts hits them.  Page-aligned entries only: the tail
        page is mid-decode."""
        n = int(self.cache.lengths[slot])
        toks = list(tokens)[:n]
        if len(toks) < n or n < self.cache.page_size:
            return  # a stream shorter than the cached rows, or no whole
            # page to index
        before = self.cache.prefix_entries
        self.cache.register_prefix(slot, toks, aligned_only=True)
        added = self.cache.prefix_entries - before
        if added > 0:
            self.metrics.inc("prefix_reindexed", added)

    # ---- slot lifecycle ----
    def alloc_slot(self) -> int:
        slot = self.cache.alloc()
        self.active[slot] = False
        return slot

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self.last_tokens[slot] = 0
        self._cursors.pop(slot, None)
        self.cache.free(slot)
