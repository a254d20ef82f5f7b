"""Live KV-cache slot migration between serving engines, in one process
(counterpart of ``hetu_tpu/serve/migrate.py`` without its van wire).

A request moved mid-decode carries its live K/V slot to the peer engine,
which decodes on token for token with zero prefill; a queued request
re-queues there.  Two layers:

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
* **orchestration** — :func:`migrate_inflight` moves every in-flight
  request from one scheduler to another, handing the host snapshots over
  directly; ANY failure re-adopts everything at the source and re-raises,
  so a migration either completes or leaves the source serving.

The K/V rows cross the host: an export is one copy from the card a slot,
an import one copy back (kv_cache.py).  The int8 codec runs where the
snapshot's rows are, on the host.

Paged engines speak this wire unchanged: a paged export gathers a slot's
LIVE pages into the same contiguous rows (page ids are local), so slot and
paged engines drain into each other, and a paged adopter re-indexes the
imported pages in its prefix index (scheduler ``adopt_inflight`` → engine
``reindex_prefix``).

The chunked van wire (``send_payload`` / ``recv_payload``), the link-rate
readings the ``auto`` codec consults (``known_link_mbps``,
``measured_link_mbps``) and ``migrate_inflight(wire=...)`` wait for the
van slice: here ``resolve_codec`` takes the rate from its caller, and a
wire raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import struct
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
    :func:`pick_codec` with the caller's ``rate_mbps`` (no rate: no
    evidence, so no compression) and the engine's live payload size."""
    if codec != "auto":
        return check_codec(codec, allow_auto=False)
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
# orchestration
# ---------------------------------------------------------------------------

def migrate_inflight(src, dst, *, wire=None) -> dict:
    """Move EVERY in-flight request from scheduler ``src`` to scheduler
    ``dst``: mid-decode requests carry their live slots (the peer decodes
    on with zero prefill), queued ones re-queue on the peer with their
    deadlines.  Returns ``{source_slot: dest_slot}``.  The host snapshots
    pass to ``dst`` directly.

    ``wire`` (the reference's van channels) raises
    ``NotImplementedError`` before anything moves: the chunked wire
    waits for the van slice, and a wire is never silently replaced by
    the in-process hand-off.

    Failure atomicity: any error re-adopts the requests AND their slots
    at the source (the slots were never released) and re-raises; if the
    source is gone too, every request is resolved.  On ``dst`` the import
    and the attachment happen under its scheduler lock
    (``adopt_inflight``)."""
    if wire is not None:
        raise NotImplementedError(
            "migrate_inflight over a van wire waits for the van slice "
            "(ROADMAP.md Queue 1 item 2b); pass wire=None to hand the "
            "slots over in this process")
    # the export and the snapshots under the source's scheduler lock: a
    # decode step between them would advance the exported slots past the
    # requests' recorded tokens
    pairs, snaps = src.export_inflight_with_slots()
    slots = [slot for _, slot in pairs if slot is not None]
    try:
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
