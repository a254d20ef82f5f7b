"""Live KV-cache slot migration between serving engines (counterpart of
``hetu_tpu/serve/migrate.py``).

A request moved mid-decode carries its live K/V slot to the peer engine,
which decodes on token for token with zero prefill; a queued request
re-queues there.  Three layers:

* **slot payloads** — :func:`pack` / :func:`unpack` serialize
  :class:`~hetu_tpu_torch.serve.kv_cache.KVSlotSnapshot` lists (and
  request records) into one self-describing byte string: magic, a JSON
  header (cache geometry, per-slot metadata, body CRC), then the raw K/V
  bytes, optionally compressed (codecs ``bf16`` and block-scaled
  ``int8``).  ``unpack`` checks magic, version, geometry and the body CRC
  before it builds any tensor, so a corrupt transfer adopts nothing.  The
  payload is BYTE-compatible with the reference's: the same magic,
  version, header keys in the same order, dtype names as numpy spells
  them and the same CRC, so a payload of either package unpacks in the
  other.  :func:`export_payload` / :func:`adopt_payload` /
  :func:`release_exported` are the scheduler halves of a drain whose two
  sides share no objects.
* **chunked wire** — :func:`send_payload` / :func:`recv_payload` move a
  payload over a van :class:`~hetu_tpu_torch.ps.van.BlobChannel` as
  CRC-framed chunks at consecutive seqs, frame for frame the reference's
  (a stream sent by one package is received by the other).  Every frame
  is a single-slot acked blob put, idempotent under a same-seq resend, so
  a transport drop mid-transfer reconnects and resumes at the unacked
  chunk.  A completed bulk send sets the link-rate gauge
  (``migrate.wire.mbps_last`` in ``telemetry.default_registry``) that the
  ``auto`` codec reads (:func:`measured_link_mbps`, :func:`known_link_mbps`).
* **orchestration** — :func:`migrate_inflight` moves every in-flight
  request from one scheduler to another, handing the host snapshots over
  directly or, with ``wire=(tx, rx)``, through a payload that crosses the
  two channels (the sender in a helper thread); ANY failure re-adopts
  everything at the source and re-raises, so a migration either completes
  or leaves the source serving.  A wire is never replaced by the
  in-process hand-off.

The K/V rows cross the host: an export is one copy from the card a slot,
an import one copy back (kv_cache.py).  The int8 codec runs where the
snapshot's rows are, on the host.

Paged engines speak this wire unchanged: a paged export gathers a slot's
LIVE pages into the same contiguous rows (page ids are local), so slot and
paged engines drain into each other, and a paged adopter re-indexes the
imported pages in its prefix index (scheduler ``adopt_inflight`` → engine
``reindex_prefix``).
"""

from __future__ import annotations

import json
import struct
import threading
import time
import warnings
import zlib

import torch

from hetu_tpu_torch.quantwire import (
    q8_decode_axes, q8_encode_axes, record_wire_bytes,
)
from hetu_tpu_torch.serve.kv_cache import KVSlotSnapshot, dtype_name
from hetu_tpu_torch.telemetry import trace

MAGIC = b"HTMG"
VERSION = 1
DEFAULT_CHUNK_BYTES = 1 << 20

# per-chunk frame header: magic, version, chunk index, total chunks,
# crc32 of this chunk's payload
_CHUNK_HDR = struct.Struct("<4sIIII")
# payload prefix: magic, version, JSON header length
_PAYLOAD_HDR = struct.Struct("<4sII")

# the dtype names a payload may carry (numpy's spelling) and this
# package's tensors for them
_DTYPES = {dtype_name(d): d for d in (torch.float32, torch.float16,
                                      torch.bfloat16, torch.float64)}


class MigrationError(RuntimeError):
    """A slot transfer failed validation (geometry, CRC, framing).  The
    receiving side adopts NOTHING when this raises."""


class MigrationTargetError(MigrationError):
    """The DESTINATION refused or failed the adoption (drained, killed,
    incompatible geometry).  A pool catches this to retry against another
    peer; source-side failures raise plain exceptions."""


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise MigrationError(f"payload names dtype {name!r}; this build "
                             f"holds {sorted(_DTYPES)}") from None


# ---------------------------------------------------------------------------
# request records
# ---------------------------------------------------------------------------

def request_record(req, *, now: float | None = None) -> dict:
    """The wire form of a mid-decode ``Request``: all a peer scheduler
    needs to continue it.  Deadlines travel as elapsed seconds since
    submission (``time.monotonic`` values are process-local)."""
    now = time.monotonic() if now is None else now
    return {
        "rid": int(req.rid),
        "prompt": [int(t) for t in req.prompt],
        "tokens": [int(t) for t in req.tokens],
        "folded": int(req.folded),
        "max_tokens": int(req.max_tokens),
        "eos_id": None if req.eos_id is None else int(req.eos_id),
        "timeout_s": req.timeout_s,
        "elapsed_s": 0.0 if req.submitted_at is None
        else max(now - req.submitted_at, 0.0),
        "requeues": int(req.requeues),
        "had_first_token": req.first_token_at is not None,
        "tenant": getattr(req, "tenant", None),
        "slo": getattr(req, "slo", None),
    }


def request_from_record(rec: dict, *, now: float | None = None):
    """Rebuild a ``Request`` from :func:`request_record` output on the
    adopting side (in one process :func:`migrate_inflight` hands the live
    objects over instead, so waiters keep their events)."""
    from hetu_tpu_torch.serve.scheduler import Request
    now = time.monotonic() if now is None else now
    req = Request(
        prompt=list(rec["prompt"]), max_tokens=int(rec["max_tokens"]),
        eos_id=rec.get("eos_id"), timeout_s=rec.get("timeout_s"))
    req.rid = int(rec["rid"])
    req.tenant = rec.get("tenant")
    req.slo = rec.get("slo")
    req.tokens = list(rec["tokens"])
    req.folded = int(rec.get("folded", 0))
    req.requeues = int(rec.get("requeues", 0))
    req.submitted_at = now - float(rec.get("elapsed_s", 0.0))
    if rec.get("had_first_token"):
        # TTFT was observed at the source; the adopter must not observe it
        # again
        req.first_token_at = req.submitted_at
    return req


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

CODECS = ("none", "bf16", "int8")


def check_codec(codec: str, *, allow_auto: bool = True) -> str:
    """Validate a KV wire codec name where it is written.  ``"auto"`` (a
    policy, resolved per drain by :func:`resolve_codec`) is accepted
    except at the pack/unpack layer (``allow_auto=False``)."""
    if codec == "auto" and allow_auto:
        return codec
    if codec not in CODECS:
        raise ValueError(f"unknown migrate codec {codec!r}; expected "
                         f"one of {CODECS}" +
                         (" or 'auto'" if allow_auto else ""))
    return codec


# a link-rate sample must come from a transfer big enough that the
# payload, not the per-frame ack pacing, set the wall time
MIN_RATE_SAMPLE_BYTES = 1 << 16


def measured_link_mbps(registry=None) -> float | None:
    """The observed bulk-transfer rate in Mbit/s: the last completed
    payload send of at least ``MIN_RATE_SAMPLE_BYTES``
    (``migrate.wire.mbps_last``, set by :func:`send_payload`), from
    ``registry`` (default ``telemetry.default_registry``).  The van's
    generic ``blob_put`` aggregate is no measure: tiny ack-paced control
    frames read orders of magnitude below the wire.  None until a bulk
    transfer has been seen (no evidence, no compression)."""
    if registry is None:
        from hetu_tpu_torch.telemetry import default_registry as registry
    g = registry.metrics().get("migrate.wire.mbps_last")
    if g is None:
        return None
    rate = float(g.value)
    return rate if rate > 0 else None


def known_link_mbps() -> float | None:
    """The best link-rate signal in this process: an installed netem
    bandwidth cap (a van netem hook bound to an object with
    ``current_rate_mbps()``) wins, else the last measured bulk-transfer
    rate, else None."""
    from hetu_tpu_torch.ps import van as _van
    em = getattr(getattr(_van, "_netem_hook", None), "__self__", None)
    if em is not None and hasattr(em, "current_rate_mbps"):
        rate = em.current_rate_mbps()
        if rate is not None:
            return rate
    return measured_link_mbps()


def estimate_payload_bytes(engine) -> int:
    """Uncompressed (codec "none") payload size of the engine's LIVE
    slots, from the cache's lengths and geometry: no export needed to
    decide a codec."""
    spec = engine.cache.spec
    per_tok = 2 * spec.num_kv_heads * spec.head_dim * spec.dtype.itemsize
    return int(engine.cache.lengths.sum()) * spec.num_layers * per_tok


def pick_codec(rate_mbps: float | None, payload_bytes: int,
               cache_dtype: str, *,
               fast_s: float = 0.05, slow_s: float = 0.5) -> str:
    """Resolve ``codec="auto"`` from the link rate: compression pays only
    when the link, not the codec's own work, bounds the transfer.

    * rate unknown, or the transfer under ``fast_s`` → ``none``;
    * a bf16 cache → ``bf16`` (lossless for it) once the transfer takes
      real time, ``int8`` when even the bf16 payload would exceed
      ``slow_s``;
    * an f32 cache → ``int8``.
    """
    if rate_mbps is None or rate_mbps <= 0 or payload_bytes <= 0:
        return "none"
    transfer_s = payload_bytes / (rate_mbps * 125_000.0)
    if transfer_s <= fast_s:
        return "none"
    if "bfloat16" in str(cache_dtype) or "bf16" in str(cache_dtype):
        return "int8" if transfer_s / 2.0 > slow_s else "bf16"
    return "int8"


def resolve_codec(codec: str, engine, *,
                  rate_mbps: float | None = None) -> str:
    """A concrete codec passes through; ``"auto"`` goes through
    :func:`pick_codec` with the engine's live payload size and the link
    rate: the caller's ``rate_mbps`` (a configured share of a link), else
    :func:`known_link_mbps` (no rate: no evidence, so no compression)."""
    if codec != "auto":
        return check_codec(codec, allow_auto=False)
    if rate_mbps is None:
        rate_mbps = known_link_mbps()
    return pick_codec(rate_mbps, estimate_payload_bytes(engine),
                      dtype_name(engine.cache.spec.dtype))


def _host_bytes(t: torch.Tensor):
    """A CPU tensor's bytes without a copy (a uint8 numpy view; it keeps
    the tensor alive)."""
    return t.detach().cpu().contiguous().view(torch.uint8).numpy()


def _encode_kv(t: torch.Tensor, codec: str) -> list:
    """One K or V tensor ``[layers, tokens, heads, head_dim]`` → its body
    parts.  ``bf16``: elementwise round to nearest even; ``int8``: one f32
    scale per (layer, head), the scales before the codes."""
    if codec == "none":
        return [_host_bytes(t)]
    if codec == "bf16":
        return [_host_bytes(t.to(torch.bfloat16))]
    if codec == "int8":
        q, scales = q8_encode_axes(t, (1, 3))
        return [_host_bytes(scales), _host_bytes(q)]
    raise ValueError(f"unknown KV codec {codec!r}; expected one of {CODECS}")


def _frombuffer(buf, dtype: torch.dtype, shape) -> torch.Tensor:
    """A tensor over ``buf``'s bytes (no copy).  The payload is read-only;
    its tensors are only read (an import copies them to the card)."""
    if len(buf) == 0:
        return torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given buffer is not "
                                                  "writable")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def _decode_kv(buf: memoryview, codec: str, dt: torch.dtype,
               shape_tail: tuple, slot: int, name: str) -> torch.Tensor:
    """Inverse of :func:`_encode_kv` back to the spec dtype; raises
    :class:`MigrationError` naming the slot on a size mismatch."""
    L, _, H, _ = shape_tail
    if codec == "none":
        return _frombuffer(buf, dt, shape_tail)
    if codec == "bf16":
        return _frombuffer(buf, torch.bfloat16, shape_tail).to(dt)
    if codec == "int8":
        scale_bytes = L * H * 4
        if len(buf) < scale_bytes:
            raise MigrationError(
                f"slot {slot}: {name} compressed body shorter than its "
                f"{L}x{H} block-scale table")
        scales = _frombuffer(buf[:scale_bytes], torch.float32, (L, 1, H, 1))
        q = _frombuffer(buf[scale_bytes:], torch.int8, shape_tail)
        return q8_decode_axes(q, scales).to(dt)
    raise MigrationError(f"payload names unknown KV codec {codec!r}; "
                         f"this build speaks {CODECS}")


def _encoded_tokens(nbytes: int, codec: str, dt: torch.dtype, L: int,
                    H: int, D: int) -> int:
    """Token count implied by an encoded K/V byte length (-1: not a whole
    number of tokens, corrupt metadata)."""
    if codec == "bf16":
        per_tok = L * H * D * 2
    elif codec == "int8":
        nbytes -= L * H * 4  # the block-scale prefix
        per_tok = L * H * D
    else:
        per_tok = L * H * D * dt.itemsize
    if nbytes < 0 or per_tok <= 0 or nbytes % per_tok:
        return -1
    return nbytes // per_tok


# ---------------------------------------------------------------------------
# payload pack/unpack
# ---------------------------------------------------------------------------

def pack(spec, snapshots, records=(), *, codec: str = "none",
         registry=None) -> bytes:
    """Serialize slot snapshots (and request records) into one migration
    payload.  ``spec`` is the source cache's ``KVCacheSpec``; the receiver
    checks it against its own before touching a slot.

    ``codec`` compresses the K/V body (``bf16``: 2 B an element, lossless
    for bf16 caches; ``int8``: about 1 B an element).  The header names
    the codec and the CRC covers the COMPRESSED bytes.  With a
    ``registry`` (a ``MetricsRegistry``), the logical and wire bytes land
    on its ``serve.migrate.bytes_*`` counters.  The body is written once,
    into the returned bytes."""
    if codec not in CODECS:
        raise ValueError(f"unknown KV codec {codec!r}; expected one of "
                         f"{CODECS}")
    with trace.span("serve.migrate.pack", {"codec": codec}) as sp:
        payload, logical, body_bytes = _pack(spec, snapshots, records,
                                             codec)
        sp.set("bytes", len(payload))
    if registry is not None:
        record_wire_bytes(registry, "serve.migrate", logical, body_bytes)
    return payload


def _pack(spec, snapshots, records, codec):
    slots_meta = []
    parts = []
    logical = body_bytes = crc = 0
    for s in snapshots:
        logical += s.nbytes
        kp, vp = _encode_kv(s.k, codec), _encode_kv(s.v, codec)
        kb, vb = (sum(p.nbytes for p in ps) for ps in (kp, vp))
        slots_meta.append({"slot": int(s.slot), "length": int(s.length),
                           "meta": dict(s.meta),
                           "k_bytes": kb, "v_bytes": vb})
        for p in kp + vp:
            crc = zlib.crc32(p, crc)
            parts.append(p)
        body_bytes += kb + vb
    header = {
        "version": VERSION,
        "codec": codec,
        "spec": {"num_layers": int(spec.num_layers),
                 "num_kv_heads": int(spec.num_kv_heads),
                 "head_dim": int(spec.head_dim),
                 "dtype": dtype_name(spec.dtype)},
        "slots": slots_meta,
        "records": list(records),
        "body_bytes": body_bytes,
        "body_crc": crc,
    }
    hb = json.dumps(header, separators=(",", ":")).encode()
    return (b"".join([_PAYLOAD_HDR.pack(MAGIC, VERSION, len(hb)), hb,
                      *parts]), logical, body_bytes)


def unpack(payload):
    """Parse a :func:`pack` payload (bytes-like) back into ``(spec_dict,
    snapshots, records)``.  Raises :class:`MigrationError` on any framing
    or CRC problem, before any snapshot is built.  The snapshots' tensors
    are read-only views of ``payload``, with no copy for codec
    ``none``."""
    with trace.span("serve.migrate.unpack") as sp:
        sp.set("bytes", len(payload))
        return _unpack(payload)


def _unpack(payload):
    mv = memoryview(payload).cast("B")
    if len(mv) < _PAYLOAD_HDR.size:
        raise MigrationError("migration payload shorter than its header")
    magic, ver, hlen = _PAYLOAD_HDR.unpack_from(mv)
    if magic != MAGIC:
        raise MigrationError(f"bad migration magic {magic!r}")
    if ver != VERSION:
        raise MigrationError(f"migration payload version {ver}; this "
                             f"build speaks {VERSION}")
    off = _PAYLOAD_HDR.size
    if len(mv) < off + hlen:
        raise MigrationError("truncated migration header")
    try:
        header = json.loads(bytes(mv[off:off + hlen]))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise MigrationError(f"corrupt migration header: {e}") from None
    body = mv[off + hlen:]
    if len(body) != int(header["body_bytes"]):
        raise MigrationError(
            f"migration body is {len(body)} bytes; header promised "
            f"{header['body_bytes']}")
    if zlib.crc32(body) != int(header["body_crc"]):
        raise MigrationError("migration body CRC mismatch: refusing to "
                             "adopt any slot from a corrupt transfer")
    spec_d = header["spec"]
    codec = header.get("codec", "none")  # payloads before codecs: raw
    if codec not in CODECS:
        raise MigrationError(f"payload names unknown KV codec {codec!r}; "
                             f"this build speaks {CODECS}")
    dt = _torch_dtype(spec_d["dtype"])
    L = int(spec_d["num_layers"])
    H = int(spec_d["num_kv_heads"])
    D = int(spec_d["head_dim"])
    snaps = []
    pos = 0
    for m in header["slots"]:
        kb, vb = int(m["k_bytes"]), int(m["v_bytes"])
        if pos + kb + vb > len(body):
            raise MigrationError("slot byte ranges overrun the body")
        # token counts come from the ENCODED byte lengths before any
        # tensor is made: corrupt metadata fails loudly
        nk = _encoded_tokens(kb, codec, dt, L, H, D)
        nv = _encoded_tokens(vb, codec, dt, L, H, D)
        if nk < 0 or nv < 0:
            raise MigrationError(
                f"slot {m['slot']}: K/V bytes do not factor into the "
                f"declared geometry under codec {codec!r}")
        try:
            k = _decode_kv(body[pos:pos + kb], codec, dt, (L, nk, H, D),
                           int(m["slot"]), "k")
            v = _decode_kv(body[pos + kb:pos + kb + vb], codec, dt,
                           (L, nv, H, D), int(m["slot"]), "v")
        except MigrationError:
            raise
        except (ValueError, RuntimeError) as e:
            raise MigrationError(
                f"slot {m['slot']}: K/V bytes do not factor into the "
                f"declared geometry ({e})") from None
        pos += kb + vb
        if nk != int(m["length"]) or nv != int(m["length"]):
            raise MigrationError(
                f"slot {m['slot']}: {nk} rows of K/V for a declared length "
                f"of {m['length']}")
        snaps.append(KVSlotSnapshot(slot=int(m["slot"]),
                                    length=int(m["length"]),
                                    k=k, v=v, meta=dict(m.get("meta", {}))))
    return spec_d, snaps, list(header.get("records", []))


def check_spec(spec, spec_dict: dict) -> None:
    """The receiver's geometry gate: the adopting cache's spec must match
    the payload's exactly (layers, kv heads, head dim, dtype)."""
    mine = {"num_layers": int(spec.num_layers),
            "num_kv_heads": int(spec.num_kv_heads),
            "head_dim": int(spec.head_dim),
            "dtype": dtype_name(spec.dtype)}
    theirs = {k: spec_dict.get(k) for k in mine}
    if mine != theirs:
        raise MigrationError(
            f"KV cache geometry mismatch: payload {theirs} vs local "
            f"{mine}: slots migrate only between engines serving the same "
            f"model geometry")


# ---------------------------------------------------------------------------
# whole-scheduler payloads (a drain whose sides share no objects)
# ---------------------------------------------------------------------------

def export_payload(scheduler, *, codec: str = "none"):
    """Export EVERY in-flight request from ``scheduler`` into one
    payload: mid-decode requests with their live snapshots, queued ones
    as bare records.  Returns ``(payload, pairs)``; the caller holds
    ``pairs`` for rollback (``scheduler.adopt_inflight(pairs)``) until
    the peer confirms, then calls :func:`release_exported`.  Each record
    carries its SOURCE slot (``rec["slot"]``, None for queued) so
    :func:`adopt_payload` can rebind it.  The payload's logical and wire
    bytes go to the scheduler's metrics registry."""
    pairs, snaps = scheduler.export_inflight_with_slots()
    try:
        records = []
        now = time.monotonic()
        for req, slot in pairs:
            rec = request_record(req, now=now)
            rec["slot"] = None if slot is None else int(slot)
            records.append(rec)
        payload = pack(scheduler.engine.cache.spec, snaps, records,
                       codec=codec, registry=scheduler.metrics.registry)
    except Exception:
        # the export held but the payload did not: the caller never got
        # `pairs`, so re-adopt here or the requests strand
        scheduler.adopt_inflight(pairs)
        raise
    return payload, pairs


def adopt_payload(scheduler, payload):
    """Adopt an :func:`export_payload` payload into ``scheduler``:
    geometry-gated and all-or-nothing (the K/V import and the request
    attachment under the adopter's scheduler lock).  The requests are
    REBUILT from their records.  Returns ``(requests, slot_map)`` in the
    payload's admission order."""
    spec_d, snaps, records = unpack(payload)
    check_spec(scheduler.engine.cache.spec, spec_d)
    now = time.monotonic()
    by_slot = {int(s.slot): s for s in snaps}
    pairs = []
    for rec in records:
        req = request_from_record(rec, now=now)
        slot = rec.get("slot")
        if slot is not None and int(slot) not in by_slot:
            raise MigrationError(
                f"record {rec.get('rid')} names source slot {slot} but the "
                f"payload carries no snapshot for it")
        pairs.append((req, None if slot is None else int(slot)))
    carried = {s for _, s in pairs if s is not None}
    orphans = sorted(set(by_slot) - carried)
    if orphans:
        raise MigrationError(
            f"payload carries snapshots for slots {orphans} that no request "
            f"record references: refusing a partial adoption")
    try:
        slot_map = scheduler.adopt_inflight(pairs, snapshots=snaps or None)
    except Exception as e:
        raise MigrationTargetError(
            f"destination failed the adoption: {e}") from e
    return [req for req, _ in pairs], slot_map


def release_exported(scheduler, pairs) -> None:
    """The commit half of a drain: the peer adopted, so the source's
    exported slots are released (best effort) and ``requests_exported``
    is charged."""
    from hetu_tpu_torch.serve.scheduler import release_slot_best_effort
    for _req, slot in pairs:
        if slot is not None:
            release_slot_best_effort(scheduler.engine, slot)
    scheduler.metrics.inc("requests_exported", len(pairs))


# ---------------------------------------------------------------------------
# chunked wire over a van blob channel
# ---------------------------------------------------------------------------

def send_payload(channel, payload, *, seq0: int = 1,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 timeout_s: float = 60.0, stop=None) -> int:
    """Send ``payload`` over a van blob channel as CRC-framed chunks at
    seqs ``[seq0, seq0 + n)``; returns the next free seq.  Each frame is
    a single-slot acked put, idempotent under a same-seq resend: a
    connection drop mid-transfer reconnects and resends the chunk in
    flight, never the payload.

    ``stop`` (a ``threading.Event``): a cooperative abort, checked
    between put slices of 0.5 s instead of one ``timeout_s`` ack wait.  A
    receiver that died mid-stream never acks, and the caller cannot close
    the channel under a blocked native put: without the slices an aborted
    transfer wedges the sender, and whoever joins it, for the whole ack
    window.  Raises :class:`MigrationError` once set.

    A completed send of at least ``MIN_RATE_SAMPLE_BYTES`` sets the link
    rate it reached (``migrate.wire.mbps_last``) in
    ``telemetry.default_registry``."""
    chunk_bytes = max(int(chunk_bytes), 1)
    n = max((len(payload) + chunk_bytes - 1) // chunk_bytes, 1)
    slice_s = 0.5 if stop is not None else timeout_s
    with trace.span("serve.migrate.send",
                    {"bytes": len(payload), "chunks": n}):
        t0 = time.perf_counter()
        for i in range(n):
            part = payload[i * chunk_bytes:(i + 1) * chunk_bytes]
            frame = _CHUNK_HDR.pack(MAGIC, VERSION, i, n,
                                    zlib.crc32(part)) + part
            deadline = time.monotonic() + timeout_s
            while True:
                if stop is not None and stop.is_set():
                    raise MigrationError(
                        f"send aborted at chunk {i}/{n}: receiver gone")
                remaining = deadline - time.monotonic()
                try:
                    channel.put(frame, seq0 + i,
                                timeout_s=max(min(slice_s, remaining),
                                              0.001))
                    break
                except TimeoutError:
                    # the ack window is still blocked: a same-seq resend
                    # is idempotent
                    if time.monotonic() >= deadline:
                        raise
        dt = time.perf_counter() - t0
    if len(payload) >= MIN_RATE_SAMPLE_BYTES and dt > 0:
        # a completed BULK transfer is the one honest link-rate sample
        # (control frames are tiny and ack-paced)
        from hetu_tpu_torch.telemetry import default_registry as reg
        reg.gauge("migrate.wire.mbps_last").set(
            len(payload) * 8.0 / (dt * 1e6))
        reg.counter("migrate.wire.rate_samples").inc()
    return seq0 + n


def recv_payload(channel, *, seq0: int = 1,
                 timeout_s: float = 60.0) -> bytes:
    """Receive a :func:`send_payload` stream.  Each chunk's framing and
    CRC are checked as it lands; the first mismatch raises
    :class:`MigrationError`, so the caller adopts nothing from a bad
    stream."""
    parts = []
    i, n = 0, 1
    with trace.span("serve.migrate.recv") as sp:
        while i < n:
            frame = channel.get(seq0 + i, timeout_s=timeout_s)
            if len(frame) < _CHUNK_HDR.size:
                raise MigrationError(f"chunk {i}: frame shorter than "
                                     f"header")
            magic, ver, idx, total, crc = _CHUNK_HDR.unpack_from(frame)
            if magic != MAGIC or ver != VERSION:
                raise MigrationError(f"chunk {i}: bad magic/version")
            if idx != i or total < 1 or (i > 0 and total != n):
                raise MigrationError(
                    f"chunk sequence corrupt: got idx {idx}/{total} at "
                    f"position {i}/{n}")
            part = frame[_CHUNK_HDR.size:]
            if zlib.crc32(part) != crc:
                raise MigrationError(f"chunk {i} CRC mismatch")
            n = total
            parts.append(part)
            i += 1
        out = b"".join(parts)
        sp.set("bytes", len(out))
    return out


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def migrate_inflight(src, dst, *, wire=None, codec: str = "none",
                     chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                     timeout_s: float = 60.0) -> dict:
    """Move EVERY in-flight request from scheduler ``src`` to scheduler
    ``dst``: mid-decode requests carry their live slots (the peer decodes
    on with zero prefill), queued ones re-queue on the peer with their
    deadlines.  Returns ``{source_slot: dest_slot}``.

    ``wire``: a ``(tx, rx)`` pair of van blob channels that the K/V
    payload crosses as CRC-checked chunks of ``chunk_bytes`` (the sender
    runs in a helper thread: a blob put blocks on the single-slot ack
    window; a failed receive stops it and joins it).  ``None`` hands the
    host snapshots to ``dst`` directly.  ``codec`` (``bf16``/``int8``,
    wire transfers only) compresses the K/V body, see :func:`pack`; the
    payload's logical and wire bytes go to the source scheduler's metrics
    registry.

    Failure atomicity: any error re-adopts the requests AND their slots
    at the source (the slots were never released) and re-raises; if the
    source is gone too, every request is resolved.  On ``dst`` the import
    and the attachment happen under its scheduler lock
    (``adopt_inflight``)."""
    # the export and the snapshots under the source's scheduler lock: a
    # decode step between them would advance the exported slots past the
    # requests' recorded tokens
    pairs, snaps = src.export_inflight_with_slots()
    slots = [slot for _, slot in pairs if slot is not None]
    try:
        if wire is not None and snaps:
            spec_d, snaps, _ = _over_wire(
                pack(src.engine.cache.spec, snaps, codec=codec,
                     registry=src.metrics.registry),
                wire, chunk_bytes, timeout_s)
            check_spec(dst.engine.cache.spec, spec_d)
        try:
            slot_map, n_adopted = dst.adopt_inflight(
                pairs, snapshots=snaps or None, return_count=True)
        except Exception as e:
            raise MigrationTargetError(
                f"destination failed the adoption: {e}") from e
    except Exception:
        try:
            src.adopt_inflight(pairs)  # the source serves on, its slots
        except Exception:              # intact
            # the source is gone too: the requests must still RESOLVE, or
            # a waiter sits out its whole timeout
            from hetu_tpu_torch.serve.scheduler import (
                finish_request, release_slot_best_effort,
            )
            for req, _ in pairs:
                if not req.done.is_set():
                    finish_request(req, req.status or "error",
                                   getattr(src, "metrics", None))
            for slot in slots:
                release_slot_best_effort(src.engine, slot)
        raise  # the ORIGINAL failure, not the rollback's
    # committed: charge requests_exported with what the destination
    # attached (requests that finished in transit were skipped there),
    # then release the source's dead slots (best effort)
    src.metrics.inc("requests_exported", n_adopted)
    from hetu_tpu_torch.serve.scheduler import release_slot_best_effort
    for slot in slots:
        release_slot_best_effort(src.engine, slot)
    return slot_map


def _over_wire(payload, wire, chunk_bytes, timeout_s):
    """``payload`` sent over ``tx`` (in a helper thread) and received on
    ``rx``; returns ``unpack`` of what arrived.  A failed receive stops
    the sender (a peer that will never ack would hold it for its whole
    ack window) and joins it before raising: the exported requests are
    off both schedulers, burning their deadlines, until the rollback
    runs."""
    tx, rx = wire
    send_exc: list = []
    send_stop = threading.Event()

    def _send():
        try:
            send_payload(tx, payload, chunk_bytes=chunk_bytes,
                         timeout_s=timeout_s, stop=send_stop)
        except Exception as e:  # raised after the join
            send_exc.append(e)

    t = threading.Thread(target=_send, daemon=True,
                         name="migrate-send")
    t.start()
    try:
        got = recv_payload(rx, timeout_s=timeout_s)
    except BaseException:
        send_stop.set()
        t.join(timeout_s)
        raise
    t.join(timeout_s)
    if send_exc:
        raise send_exc[0]
    return unpack(got)
