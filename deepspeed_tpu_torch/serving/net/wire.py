"""Versioned length-prefixed binary frames for the remote KV wire.

Copy of ``deepspeed_tpu/serving/net/wire.py``: the same frames, byte for
byte, so a port process and a JAX process can serve each other's KV
blocks and control channels. Two things differ, neither in the bytes:

- **bfloat16 on the wire.** numpy has no bfloat16, so the port's host
  payloads carry a bf16 pool's planes as their ``uint16`` bits
  (``inference/v2/engine_v2.py``). The JAX package tags each plane with its
  numpy dtype's name, ``bfloat16`` for a bf16 plane (ml_dtypes). The port
  writes ``bfloat16`` for the planes the caller names in ``bf16=`` (the
  exporter names the planes of its bf16 pools: ``transport.bf16_planes``)
  with the raw bits as the payload, and reads a ``bfloat16`` plane back
  as ``uint16`` bits, without ml_dtypes. Every other plane keeps its numpy
  dtype's name, so a genuine ``uint16`` plane stays ``uint16``.
- **Fewer copies.** ``encode_chunk`` writes a window's planes straight
  into one frame buffer, and ``recv_exact`` reads into one; a decoded
  plane is a writable view of the frame it came in.

The remote KV transport serializes the ``host`` payload representation —
the per-plane numpy arrays ``export_kv_blocks`` produces — into framed
byte strings a stdlib socket can carry between processes/hosts. One frame
is::

    offset  size  field
    0       4     magic  b"DSKV"
    4       2     protocol version (u16 LE) == PROTOCOL_VERSION
    6       2     frame type (u16 LE, one of F_*)
    8       8     payload length (u64 LE)
    16      4     CRC32 of the payload (u32 LE)
    20      N     payload

Decode is STRICT: a frame with foreign magic, a protocol version outside
the supported range, an unknown type, a length beyond
``MAX_FRAME_BYTES``, a payload shorter than its header promises, or a
checksum mismatch raises :class:`WireError` naming exactly what was
wrong — a corrupt or truncated frame must never scatter garbage into a
live KV pool (the pool-side ``check_kv_payload`` contract is the second
fence, this is the first).

Version negotiation: HELLO payloads carry the sender's
``min_version``/``max_version`` span (an EMPTY payload is a legacy v1
peer) and :func:`negotiate_version` picks the highest common version —
skew inside ``[MIN_PROTOCOL_VERSION, PROTOCOL_VERSION]`` downgrades
instead of disconnecting. Truly foreign peers still fail strictly:
wrong magic, or a version span with no overlap.

Control frames (HELLO/FETCH/CREDIT/ERROR/META and the cluster
control-plane vocabulary SUBMIT/TOKEN/CANCEL/HEALTH/ADOPT/STATS/EVENT/
GOODBYE) carry JSON; CHUNK frames carry a binary plane dict — per plane:
name, dtype string, shape, raw bytes — so quantized int8 codes and their
fp32 scale planes cross the wire bit-exactly (no text re-encoding of
array data ever).
"""

import json
import struct
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "PROTOCOL_VERSION",
    "MIN_PROTOCOL_VERSION",
    "MAGIC",
    "MAX_FRAME_BYTES",
    "F_HELLO",
    "F_FETCH",
    "F_CHUNK",
    "F_CREDIT",
    "F_DONE",
    "F_ERROR",
    "F_META",
    "F_SUBMIT",
    "F_TOKEN",
    "F_CANCEL",
    "F_HEALTH",
    "F_ADOPT",
    "F_STATS",
    "F_EVENT",
    "F_GOODBYE",
    "FRAME_NAMES",
    "WireError",
    "encode_frame",
    "decode_frame",
    "read_frame",
    "recv_exact",
    "encode_json",
    "decode_json",
    "encode_hello",
    "decode_hello",
    "negotiate_version",
    "BF16",
    "encode_planes",
    "decode_planes",
    "encode_chunk",
    "decode_chunk",
    "encode_handoff_meta",
    "decode_handoff_meta",
]

MAGIC = b"DSKV"
# v1: KV fetch wire (HELLO..META). v2 adds the cluster control-plane
# vocabulary (SUBMIT..GOODBYE). The span [MIN_PROTOCOL_VERSION,
# PROTOCOL_VERSION] is what this build can SPEAK; HELLO negotiation picks
# the highest version both spans share.
PROTOCOL_VERSION = 2
MIN_PROTOCOL_VERSION = 1
# header: magic, version, frame type, payload length, payload crc32
_HEADER = struct.Struct("<4sHHQI")
HEADER_BYTES = _HEADER.size
# one chunk window of KV blocks is at most a few hundred MB even at
# production shapes; anything past this is a corrupt length field, not a
# payload — reject before trying to allocate it
MAX_FRAME_BYTES = 1 << 32

F_HELLO = 1   # version handshake (both directions; {min_version, max_version})
F_FETCH = 2   # importer -> exporter: {tid, start_block, credit_blocks}
F_CHUNK = 3   # exporter -> importer: binary block-window planes
F_CREDIT = 4  # importer -> exporter: {blocks} replenishing the window
F_DONE = 5    # importer -> exporter: transfer landed, release the stage
F_ERROR = 6   # either direction: {error} then close
F_META = 7    # out-of-band handoff descriptor (cross-process bootstrap)
# -- control plane (v2): router <-> replica agent -----------------------------
F_SUBMIT = 8    # router -> agent: {uid, prompt, params} new resident request
F_TOKEN = 9     # agent -> router: {uid, tok} / {uid, fin} token pump
F_CANCEL = 10   # router -> agent: {uid} release a resident (cancel/finish)
F_HEALTH = 11   # router -> agent: probation probe; reply {ok} or ERROR
F_ADOPT = 12    # router -> agent: {req, meta} import a KV handoff and decode
F_STATS = 13    # agent -> router: replica stats + prefix advertisement
F_EVENT = 14    # agent -> router: lifecycle/control-plane event mirror
F_GOODBYE = 15  # either direction: clean teardown of a control channel

FRAME_NAMES = {
    F_HELLO: "HELLO", F_FETCH: "FETCH", F_CHUNK: "CHUNK",
    F_CREDIT: "CREDIT", F_DONE: "DONE", F_ERROR: "ERROR", F_META: "META",
    F_SUBMIT: "SUBMIT", F_TOKEN: "TOKEN", F_CANCEL: "CANCEL",
    F_HEALTH: "HEALTH", F_ADOPT: "ADOPT", F_STATS: "STATS",
    F_EVENT: "EVENT", F_GOODBYE: "GOODBYE",
}


class WireError(RuntimeError):
    """A frame failed the strict decode (truncated, corrupt, foreign
    version/magic, unknown type) or the peer broke protocol."""


def encode_frame(ftype: int, payload: bytes = b"",
                 version: int = PROTOCOL_VERSION) -> bytes:
    """One framed message: header (magic, version, type, length, crc32)
    followed by the payload bytes. ``version`` defaults to this build's
    newest; a channel that negotiated a downgrade passes the agreed
    version so the peer's strict decode accepts every frame."""
    if ftype not in FRAME_NAMES:
        raise ValueError(f"unknown frame type {ftype}")
    if not (MIN_PROTOCOL_VERSION <= int(version) <= PROTOCOL_VERSION):
        raise ValueError(
            f"cannot encode v{version} frames (this build speaks "
            f"v{MIN_PROTOCOL_VERSION}..v{PROTOCOL_VERSION})")
    payload = bytes(payload)
    return _HEADER.pack(MAGIC, int(version), ftype, len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _check_header(magic: bytes, version: int, ftype: int, length: int):
    if magic != MAGIC:
        raise WireError(
            f"foreign frame: magic {magic!r} != {MAGIC!r} — peer is not a "
            "dstpu KV endpoint")
    if not (MIN_PROTOCOL_VERSION <= version <= PROTOCOL_VERSION):
        raise WireError(
            f"protocol version skew: peer speaks v{version}, this build "
            f"speaks v{MIN_PROTOCOL_VERSION}..v{PROTOCOL_VERSION} — "
            "refusing to guess at the frame layout")
    if ftype not in FRAME_NAMES:
        raise WireError(f"unknown frame type {ftype} (v{PROTOCOL_VERSION} "
                        f"knows {sorted(FRAME_NAMES)})")
    if length > MAX_FRAME_BYTES:
        raise WireError(
            f"frame length {length} exceeds MAX_FRAME_BYTES "
            f"{MAX_FRAME_BYTES} — corrupt length field")


def _check_payload(payload: bytes, crc: int, ftype: int):
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise WireError(
            f"checksum mismatch on {FRAME_NAMES[ftype]} frame: payload "
            "corrupted in flight")


def decode_frame(buf: bytes, offset: int = 0) -> Tuple[int, bytes, int]:
    """Strictly decode one frame from ``buf`` at ``offset``. Returns
    ``(frame_type, payload, next_offset)``; raises :class:`WireError` on
    truncation, corruption, or version/magic skew."""
    view = memoryview(buf)
    if len(view) - offset < HEADER_BYTES:
        raise WireError(
            f"truncated frame: {len(view) - offset} bytes < "
            f"{HEADER_BYTES}-byte header")
    magic, version, ftype, length, crc = _HEADER.unpack_from(view, offset)
    _check_header(magic, version, ftype, length)
    start = offset + HEADER_BYTES
    if len(view) - start < length:
        raise WireError(
            f"truncated {FRAME_NAMES[ftype]} frame: header promises "
            f"{length} payload bytes, only {len(view) - start} present")
    payload = bytes(view[start:start + length])
    _check_payload(payload, crc, ftype)
    return ftype, payload, start + length


def recv_exact(sock, n: int) -> bytearray:
    """Read exactly ``n`` bytes from a socket into one buffer; a peer that
    hangs up mid-read surfaces as a :class:`WireError`, never a short
    buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise WireError(
                f"connection closed mid-frame: wanted {n} bytes, got "
                f"{got} — peer crashed or hung up")
        got += k
    return buf


def read_frame(read: Callable[[int], bytes]) -> Tuple[int, bytes]:
    """Read one frame through ``read(n)`` (which must return exactly ``n``
    bytes or raise). Returns ``(frame_type, payload)``."""
    header = read(HEADER_BYTES)
    magic, version, ftype, length, crc = _HEADER.unpack(header)
    _check_header(magic, version, ftype, length)
    payload = read(length) if length else b""
    _check_payload(payload, crc, ftype)
    return ftype, payload


# -- JSON control payloads ---------------------------------------------------
def encode_json(ftype: int, obj: Dict) -> bytes:
    return encode_frame(ftype, json.dumps(obj, separators=(",", ":"),
                                          sort_keys=True).encode("utf-8"))


def decode_json(payload: bytes, ftype: int = 0) -> Dict:
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        name = FRAME_NAMES.get(ftype, ftype)
        raise WireError(f"malformed JSON payload in {name} frame: {e}") from e
    if not isinstance(obj, dict):
        raise WireError(f"JSON payload must be an object, got {type(obj).__name__}")
    return obj


# -- HELLO version negotiation ------------------------------------------------
def encode_hello(extra: Optional[Dict] = None) -> bytes:
    """A HELLO frame carrying this build's speakable version span (plus
    optional channel metadata, e.g. the control plane's bootstrap role)."""
    obj = dict(extra or {})
    obj["min_version"] = MIN_PROTOCOL_VERSION
    obj["max_version"] = PROTOCOL_VERSION
    return encode_json(F_HELLO, obj)


def decode_hello(payload: bytes) -> Dict:
    """Decode a HELLO payload into its announcement dict. An EMPTY payload
    is a legacy v1 peer (v1 HELLOs carried nothing) — it reads as the
    span {1, 1} so negotiation downgrades instead of disconnecting."""
    if not payload:
        return {"min_version": 1, "max_version": 1}
    obj = decode_json(payload, F_HELLO)
    obj.setdefault("min_version", 1)
    obj.setdefault("max_version", obj["min_version"])
    return obj


def negotiate_version(hello: Dict) -> int:
    """Highest protocol version both the local build and the peer's HELLO
    span can speak. No overlap is a truly foreign peer — strict
    :class:`WireError`, exactly like bad magic."""
    try:
        peer_min = int(hello.get("min_version", 1))
        peer_max = int(hello.get("max_version", peer_min))
    except (TypeError, ValueError) as e:
        raise WireError(f"malformed HELLO version span: {e}") from e
    if peer_min > peer_max:
        raise WireError(
            f"malformed HELLO version span: min {peer_min} > max {peer_max}")
    agreed = min(PROTOCOL_VERSION, peer_max)
    if agreed < max(MIN_PROTOCOL_VERSION, peer_min):
        raise WireError(
            f"no common protocol version: peer speaks v{peer_min}..v{peer_max}, "
            f"this build speaks v{MIN_PROTOCOL_VERSION}..v{PROTOCOL_VERSION}")
    return agreed


# -- binary plane dicts (CHUNK frames) ---------------------------------------
_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


BF16 = "bfloat16"


def _plane_dtype_name(name: str, arr: np.ndarray, bf16) -> str:
    """The dtype string a plane is tagged with: ``bfloat16`` for a plane
    named in ``bf16`` (its 16-bit integer bits), else its numpy dtype's
    name."""
    if name in bf16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "ui":
            raise ValueError(
                f"plane {name!r}: bfloat16 bits must be a 16-bit integer "
                f"array, got {arr.dtype}")
        return BF16
    return str(np.dtype(arr.dtype))


def _plane_record(name: str, arr: np.ndarray, bf16) -> bytes:
    """A plane record's fields before its raw bytes: name, dtype string,
    ndim, dims, payload length."""
    nb = name.encode("utf-8")
    db = _plane_dtype_name(name, arr, bf16).encode("utf-8")
    parts = [_U16.pack(len(nb)), nb, _U16.pack(len(db)), db, _U8.pack(arr.ndim)]
    parts.extend(_U32.pack(dim) for dim in arr.shape)
    parts.append(_U64.pack(arr.size * arr.dtype.itemsize))
    return b"".join(parts)


def _planes_buffer(planes: Dict[str, np.ndarray], bf16, head: int,
                   prefix: bytes) -> bytearray:
    """``head`` free bytes, ``prefix``, then the plane records of
    ``planes`` in name order, each plane copied once, straight from its
    (possibly strided) array into place."""
    arrays = {name: np.asarray(planes[name]) for name in sorted(planes)}
    records = [_plane_record(name, arr, bf16) for name, arr in arrays.items()]
    buf = bytearray(head + len(prefix) + 2
                    + sum(len(r) + a.nbytes for r, a in zip(records, arrays.values())))
    pos = head
    for part in (prefix, _U16.pack(len(arrays))):
        buf[pos:pos + len(part)] = part
        pos += len(part)
    for rec, arr in zip(records, arrays.values()):
        buf[pos:pos + len(rec)] = rec
        pos += len(rec)
        dst = np.frombuffer(buf, dtype=arr.dtype, count=arr.size, offset=pos)
        np.copyto(dst.reshape(arr.shape), arr)
        pos += arr.nbytes
    return buf


def encode_planes(planes: Dict[str, np.ndarray], bf16=()) -> bytes:
    """Binary-serialize a plane dict (name -> ndarray) preserving dtype,
    shape, and every payload byte exactly. bf16 codes and fp32 scales
    cross as raw bytes — there is no text round-trip to lose bits in.
    The planes named in ``bf16`` are bfloat16 bits held as a 16-bit
    integer array and are tagged ``bfloat16``."""
    return bytes(_planes_buffer(planes, bf16, 0, b""))


def decode_planes(payload: bytes, offset: int = 0
                  ) -> Tuple[Dict[str, np.ndarray], int]:
    """Strict inverse of :func:`encode_planes`; returns the plane dict and
    the next offset. Truncated or inconsistent plane records raise
    :class:`WireError` (shape/dtype validity against the live pool is the
    importer's ``check_kv_payload`` contract, applied after this). A
    ``bfloat16`` plane comes back as its ``uint16`` bits. Each plane is a
    view of ``payload`` (writable when the payload is a bytearray)."""
    view = memoryview(payload)

    def take(n: int, what: str) -> memoryview:
        nonlocal offset
        if len(view) - offset < n:
            raise WireError(
                f"truncated plane record: wanted {n} bytes for {what}, "
                f"{len(view) - offset} left")
        out = view[offset:offset + n]
        offset += n
        return out

    (n_planes,) = _U16.unpack(take(2, "plane count"))
    planes: Dict[str, np.ndarray] = {}
    for _ in range(n_planes):
        (name_len,) = _U16.unpack(take(2, "name length"))
        name = bytes(take(name_len, "plane name")).decode("utf-8")
        (dtype_len,) = _U16.unpack(take(2, "dtype length"))
        dtype_s = bytes(take(dtype_len, "dtype string")).decode("utf-8")
        if dtype_s == BF16:
            dtype = np.dtype(np.uint16)  # the bits, as the port holds bf16
        else:
            try:
                dtype = np.dtype(dtype_s)
            except TypeError as e:
                raise WireError(
                    f"plane {name!r}: unknown dtype {dtype_s!r}") from e
        (ndim,) = _U8.unpack(take(1, "ndim"))
        shape = tuple(_U32.unpack(take(4, "dim"))[0] for _ in range(ndim))
        (raw_len,) = _U64.unpack(take(8, "payload length"))
        expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if raw_len != expect:
            raise WireError(
                f"plane {name!r}: {raw_len} payload bytes != {expect} for "
                f"shape {shape} dtype {dtype_s}")
        raw = take(raw_len, f"plane {name!r} data")
        planes[name] = np.frombuffer(raw, dtype=dtype).reshape(shape)
    return planes, offset


def encode_chunk(lo: int, hi: int, planes: Dict[str, np.ndarray],
                 bf16=()) -> bytearray:
    """One block-granular chunk window: source block columns ``[lo, hi)``
    plus the plane slices covering them (``bf16`` as in
    :func:`encode_planes`). The bytes equal ``encode_frame(F_CHUNK, lo +
    hi + encode_planes(planes))``, built in one buffer: each plane is
    copied once, and the payload is not copied again for the header."""
    buf = _planes_buffer(planes, bf16, HEADER_BYTES, _U32.pack(lo) + _U32.pack(hi))
    length = len(buf) - HEADER_BYTES
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"CHUNK of {length} bytes exceeds MAX_FRAME_BYTES")
    crc = zlib.crc32(memoryview(buf)[HEADER_BYTES:]) & 0xFFFFFFFF
    _HEADER.pack_into(buf, 0, MAGIC, PROTOCOL_VERSION, F_CHUNK, length, crc)
    return buf


def decode_chunk(payload: bytes) -> Tuple[int, int, Dict[str, np.ndarray]]:
    if len(payload) < 8:
        raise WireError("truncated CHUNK payload: missing block range")
    (lo,) = _U32.unpack_from(payload, 0)
    (hi,) = _U32.unpack_from(payload, 4)
    if hi <= lo:
        raise WireError(f"CHUNK block range [{lo}, {hi}) is empty or inverted")
    planes, end = decode_planes(payload, 8)
    if end != len(payload):
        raise WireError(
            f"CHUNK payload has {len(payload) - end} trailing bytes after "
            "the plane records")
    return lo, hi, planes


# -- handoff descriptors (cross-process bootstrap) ---------------------------
def encode_handoff_meta(handoff) -> bytes:
    """Frame a :class:`KVHandoff`'s METADATA (no payload planes) so a
    different process can import it: token history, cursors, and the
    exporter endpoint + transfer id the remote wire fetches from."""
    if handoff.endpoint is None or handoff.transfer_id is None:
        raise WireError(
            f"handoff {handoff.uid} has no endpoint/transfer_id — only "
            "remote-transport exports can cross a process boundary")
    return encode_json(F_META, {
        "uid": int(handoff.uid),
        "tokens": [int(t) for t in handoff.tokens],
        "seen_tokens": int(handoff.seen_tokens),
        "pending_token": int(handoff.pending_token),
        "n_blocks": int(handoff.n_blocks),
        "transport": handoff.transport,
        "chunk_blocks": int(handoff.chunk_blocks),
        "nbytes": int(handoff.nbytes),
        "endpoint": [str(handoff.endpoint[0]), int(handoff.endpoint[1])],
        "transfer_id": str(handoff.transfer_id),
    })


def decode_handoff_meta(data: bytes):
    """Strictly decode a META frame back into a payload-less
    :class:`KVHandoff` aimed at the exporter's endpoint."""
    from deepspeed_tpu_torch.serving.cluster.handoff import KVHandoff

    ftype, payload, _ = decode_frame(data)
    if ftype != F_META:
        raise WireError(
            f"expected META frame, got {FRAME_NAMES.get(ftype, ftype)}")
    obj = decode_json(payload, F_META)
    missing = [k for k in ("uid", "tokens", "seen_tokens", "pending_token",
                           "n_blocks", "transport", "chunk_blocks",
                           "endpoint", "transfer_id") if k not in obj]
    if missing:
        raise WireError(f"META frame missing fields {missing}")
    return KVHandoff(
        uid=int(obj["uid"]),
        tokens=[int(t) for t in obj["tokens"]],
        seen_tokens=int(obj["seen_tokens"]),
        pending_token=int(obj["pending_token"]),
        n_blocks=int(obj["n_blocks"]),
        payload=None,
        transport=str(obj["transport"]),
        chunk_blocks=int(obj["chunk_blocks"]),
        nbytes=int(obj.get("nbytes", 0)),
        endpoint=(str(obj["endpoint"][0]), int(obj["endpoint"][1])),
        transfer_id=str(obj["transfer_id"]),
    )
