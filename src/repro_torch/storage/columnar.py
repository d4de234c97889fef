"""Trait-aware columnar encoding for UIH stripes (paper §4.1.2).

A stripe is a column-oriented matrix: rows = chronologically ordered events,
columns = typed traits. Encodings exploit per-trait density/value structure:

  * ``dense_monotone`` (timestamps): delta encoding + minimal bit-width packing
  * ``dense_id`` / ``dense_value``: frame-of-reference (min-offset) + bit-width
  * ``sparse_flag`` (like/comment/share): presence bitmap (packbits); raw int8
    fallback if the column is actually dense
  * ``categorical``: dictionary (unique values) + bit-width-packed codes

The serialized layout stores a msgpack header with *per-column byte offsets*, so
**selective decoding** (§4.1.2 "secondary-level projection") skips irrelevant
columns entirely at the byte level. An optional zstd pass compresses the column
payloads (off by default: the bit-level codecs already dominate, and benchmarks
measure both).

``StripeDecodeCache`` is the store-side block-cache analogue (§4.2.3) for the
batched read path: a bounded, thread-safe LRU of *decoded* stripes keyed on
``(blob identity, traits)``, so a hot stripe touched by many requests of one
batch (same-user, same-day traffic) is decoded once and shared.
"""
from __future__ import annotations

import struct
import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import msgpack
import numpy as np

from repro_torch.core import events as ev

MAGIC = b"UIHC"
VERSION = 1

_WIDTHS = (np.uint8, np.uint16, np.uint32, np.uint64)


def _pack_unsigned(arr: np.ndarray) -> Tuple[bytes, dict]:
    """Frame-of-reference + minimal byte-width packing of an integer column."""
    assert arr.ndim == 1
    if arr.size == 0:
        return b"", {"codec": "empty", "n": 0}
    lo = int(arr.min())
    shifted = (arr.astype(np.int64) - lo).astype(np.uint64)
    hi = int(shifted.max())
    for w in _WIDTHS:
        if hi <= np.iinfo(w).max:
            payload = shifted.astype(w).tobytes()
            return payload, {"codec": "for", "n": int(arr.size), "lo": lo,
                             "w": int(np.dtype(w).itemsize)}
    raise AssertionError("unreachable")


def _unpack_unsigned(payload: bytes, meta: dict, dtype: np.dtype) -> np.ndarray:
    if meta["codec"] == "empty":
        return np.zeros(0, dtype=dtype)
    w = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[meta["w"]]
    arr = np.frombuffer(payload, dtype=w).astype(np.int64) + meta["lo"]
    return arr.astype(dtype)


def encode_column(arr: np.ndarray, encoding: str) -> Tuple[bytes, dict]:
    n = int(arr.size)
    if n == 0:
        return b"", {"codec": "empty", "n": 0, "enc": encoding}

    if encoding == ev.DENSE_MONOTONE:
        base = int(arr[0])
        deltas = np.diff(arr.astype(np.int64), prepend=arr[0])  # deltas[0]=0
        payload, meta = _pack_unsigned(deltas)
        meta.update(enc=encoding, codec="delta", base=base, inner=meta["codec"])
        return payload, meta

    if encoding == ev.SPARSE_FLAG:
        nz = int(np.count_nonzero(arr))
        if nz * 8 < n:  # sparse enough for a presence bitmap to pay off
            bits = np.packbits(arr.astype(bool))
            return bits.tobytes(), {"codec": "bitmap", "n": n, "enc": encoding}
        return arr.astype(np.int8).tobytes(), {"codec": "raw8", "n": n, "enc": encoding}

    if encoding == ev.CATEGORICAL:
        uniq, codes = np.unique(arr, return_inverse=True)
        if uniq.size <= max(2, n // 4):  # dictionary pays off
            code_payload, code_meta = _pack_unsigned(codes.astype(np.int64))
            dict_payload, dict_meta = _pack_unsigned(uniq.astype(np.int64))
            header = {"codec": "dict", "n": n, "enc": encoding,
                      "codes": code_meta, "dict": dict_meta,
                      "split": len(code_payload)}
            return code_payload + dict_payload, header
        payload, meta = _pack_unsigned(arr.astype(np.int64))
        meta.update(enc=encoding)
        return payload, meta

    # DENSE_ID / DENSE_VALUE and any unknown encoding: frame-of-reference pack
    payload, meta = _pack_unsigned(arr.astype(np.int64))
    meta.update(enc=encoding)
    return payload, meta


def decode_column(payload: bytes, meta: dict, dtype: np.dtype) -> np.ndarray:
    codec = meta["codec"]
    if codec == "empty":
        return np.zeros(0, dtype=dtype)
    if codec == "delta":
        inner = dict(meta)
        inner["codec"] = meta["inner"]
        deltas = _unpack_unsigned(payload, inner, np.int64)
        out = np.cumsum(deltas) + meta["base"]
        # cumsum includes deltas[0]=0 so out[0]=base
        return out.astype(dtype)
    if codec == "bitmap":
        n = meta["n"]
        bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8), count=n)
        return bits.astype(dtype)
    if codec == "raw8":
        return np.frombuffer(payload, dtype=np.int8).astype(dtype)
    if codec == "dict":
        split = meta["split"]
        codes = _unpack_unsigned(payload[:split], meta["codes"], np.int64)
        dictionary = _unpack_unsigned(payload[split:], meta["dict"], np.int64)
        return dictionary[codes].astype(dtype)
    if codec == "for":
        return _unpack_unsigned(payload, meta, dtype)
    raise ValueError(f"unknown codec {codec}")


# ---------------------------------------------------------------------------
# Stripe-level encode/decode
# ---------------------------------------------------------------------------

def stripe_checksum(batch: ev.EventBatch) -> int:
    """Order-sensitive checksum over all columns (used for O2O validation)."""
    crc = 0
    for name in sorted(batch.keys()):
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(batch[name]).tobytes(), crc)
    return crc & 0xFFFFFFFF


def encode_stripe(
    batch: ev.EventBatch,
    schema: ev.TraitSchema,
    compress: bool = False,
) -> bytes:
    """Encode an event batch into a self-describing stripe blob."""
    n = ev.batch_len(batch)
    cols: List[dict] = []
    payloads: List[bytes] = []
    offset = 0
    for name in batch.keys():
        spec = schema.spec(name)
        payload, meta = encode_column(batch[name], spec.encoding)
        meta["name"] = name
        meta["dtype"] = np.dtype(spec.dtype).str
        meta["off"] = offset
        meta["len"] = len(payload)
        offset += len(payload)
        cols.append(meta)
        payloads.append(payload)
    body = b"".join(payloads)
    if compress:
        import zstandard as zstd

        body = zstd.ZstdCompressor(level=3).compress(body)
    header = msgpack.packb(
        {"n": n, "cols": cols, "zstd": bool(compress),
         "crc": stripe_checksum(batch)},
        use_bin_type=True,
    )
    return MAGIC + struct.pack("<HI", VERSION, len(header)) + header + body


def _read_header(blob: bytes) -> Tuple[dict, int]:
    assert blob[:4] == MAGIC, "bad stripe magic"
    version, hlen = struct.unpack_from("<HI", blob, 4)
    assert version == VERSION
    header = msgpack.unpackb(blob[10 : 10 + hlen], raw=False)
    return header, 10 + hlen


def stripe_num_events(blob: bytes) -> int:
    header, _ = _read_header(blob)
    return header["n"]


def decode_stripe(
    blob: bytes,
    schema: ev.TraitSchema,
    traits: Optional[Sequence[str]] = None,
) -> ev.EventBatch:
    """Decode a stripe; ``traits`` enables byte-level selective decoding."""
    header, body_off = _read_header(blob)
    body = blob[body_off:]
    if header["zstd"]:
        import zstandard as zstd

        body = zstd.ZstdDecompressor().decompress(body)
    want = set(traits) if traits is not None else None
    out: ev.EventBatch = {}
    for meta in header["cols"]:
        name = meta["name"]
        if want is not None and name not in want:
            continue  # selective decode: skip at byte level
        payload = body[meta["off"] : meta["off"] + meta["len"]]
        out[name] = decode_column(payload, meta, np.dtype(meta["dtype"]))
    if want is not None:
        missing = want - set(out)
        assert not missing, f"stripe missing traits {missing}"
    return out


class StripeDecodeCache:
    """Bounded LRU of decoded stripes keyed on ``(blob identity, traits)``.

    The cache holds a reference to each cached blob, so ``id(blob)`` stays
    unique among live keys (an evicted entry drops its reference and the key
    with it). Hits return a shallow copy of the column dict — the arrays are
    shared read-only, the dict is caller-private. Thread-safe: the batched
    executor decodes from several shard threads concurrently.
    """

    def __init__(self, max_entries: int = 256):
        assert max_entries > 0
        self.max_entries = max_entries
        # key -> (blob ref, decoded batch)
        self._entries: "OrderedDict[Tuple[int, Optional[Tuple[str, ...]]], Tuple[bytes, ev.EventBatch]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(
        self,
        blob: bytes,
        schema: ev.TraitSchema,
        traits: Optional[Sequence[str]] = None,
    ) -> Tuple[ev.EventBatch, bool]:
        """Decoded stripe + whether it was served from cache."""
        key = (id(blob), tuple(traits) if traits is not None else None)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] is blob:
                self._entries.move_to_end(key)
                self.hits += 1
                return dict(entry[1]), True
        batch = decode_stripe(blob, schema, traits)
        for arr in batch.values():  # shared across callers: freeze, don't corrupt
            arr.flags.writeable = False
        with self._lock:
            self.misses += 1
            self._entries[key] = (blob, batch)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return dict(batch), False

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


def decoded_bytes_for(blob: bytes, traits: Optional[Sequence[str]] = None) -> int:
    """How many payload bytes a (possibly projected) decode touches.

    Used by the benchmarks to account selective-decoding I/O savings without
    relying on wall-clock noise.
    """
    header, _ = _read_header(blob)
    want = set(traits) if traits is not None else None
    total = 0
    for meta in header["cols"]:
        if want is None or meta["name"] in want:
            total += meta["len"]
    return total
