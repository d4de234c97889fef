"""Version metadata + training-example records (paper §3.3).

The versioned late materialization protocol replaces the O(seq_len) UIH payload
of a Fat Row with O(1) *version metadata*: temporal boundaries
(start_ts, end_ts), the sequence length at snapshot time, an optional checksum
for reconstruction validation, and the immutable-store generation.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional

import msgpack
import numpy as np

from repro_torch.core import events as ev
from repro_torch.storage import columnar


@dataclasses.dataclass(frozen=True)
class VersionMetadata:
    """O(1) pointer to an immutable UIH window. ~40 bytes regardless of seq len."""

    start_ts: int       # inclusive lower temporal bound of the immutable window
    end_ts: int         # inclusive upper bound (== immutable watermark at T_request)
    seq_len: int        # immutable events inside the window at snapshot time
    checksum: int       # crc32 over (timestamp,item_id) of the window; 0 = absent
    generation: int     # immutable-store generation observed at snapshot time

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "VersionMetadata":
        return VersionMetadata(**d)


def window_checksum(batch: ev.EventBatch) -> int:
    """Checksum of the identity columns of an immutable window.

    Computed over (timestamp, item_id) only, so it is invariant to trait/
    feature-group projection of SideInfo columns but still pins the exact event
    set + order — which is what O2O consistency requires."""
    crc = zlib.crc32(np.ascontiguousarray(batch["timestamp"]).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(batch["item_id"]).tobytes(), crc)
    return crc & 0xFFFFFFFF


@dataclasses.dataclass
class TrainingExample:
    """One logged ranking request joined with its late-arriving labels.

    Exactly one of (``version``, ``fat_uih``) is set:
      * VLM example: ``mutable_uih`` (small recent slice) + ``version`` metadata
      * Fat Row example: ``fat_uih`` holds the complete materialized UIH
    """

    request_id: int
    user_id: int
    request_ts: int
    label_ts: int
    candidate: Dict[str, int]           # e.g. {"item_id": ..., "category": ...}
    labels: Dict[str, float]            # e.g. {"click": 1.0, "watch_time": 3.2}
    mutable_uih: Optional[ev.EventBatch] = None
    version: Optional[VersionMetadata] = None
    fat_uih: Optional[ev.EventBatch] = None
    context: bytes = b""              # non-sequence features (opaque payload)

    @property
    def is_fat(self) -> bool:
        return self.fat_uih is not None

    # -- serialization (real bytes; used for bandwidth accounting) ----------
    def to_bytes(self, schema: ev.TraitSchema) -> bytes:
        head = {
            "request_id": self.request_id,
            "user_id": self.user_id,
            "request_ts": self.request_ts,
            "label_ts": self.label_ts,
            "candidate": self.candidate,
            "labels": self.labels,
            "version": self.version.to_dict() if self.version else None,
            "fat": self.is_fat,
        }
        parts = [msgpack.packb(head, use_bin_type=True), self.context]
        if self.mutable_uih is not None:
            parts.append(columnar.encode_stripe(self.mutable_uih, schema))
        else:
            parts.append(b"")
        if self.fat_uih is not None:
            parts.append(columnar.encode_stripe(self.fat_uih, schema))
        else:
            parts.append(b"")
        out = bytearray()
        for p in parts:
            out += len(p).to_bytes(4, "little")
            out += p
        return bytes(out)

    @staticmethod
    def from_bytes(blob: bytes, schema: ev.TraitSchema) -> "TrainingExample":
        parts = []
        off = 0
        for _ in range(4):
            ln = int.from_bytes(blob[off : off + 4], "little")
            off += 4
            parts.append(blob[off : off + ln])
            off += ln
        head = msgpack.unpackb(parts[0], raw=False, strict_map_key=False)
        context = parts[1]
        mutable = (
            columnar.decode_stripe(parts[2], schema) if parts[2] else None
        )
        fat = columnar.decode_stripe(parts[3], schema) if parts[3] else None
        return TrainingExample(
            request_id=head["request_id"],
            user_id=head["user_id"],
            request_ts=head["request_ts"],
            label_ts=head["label_ts"],
            candidate=head["candidate"],
            labels=head["labels"],
            mutable_uih=mutable,
            version=VersionMetadata.from_dict(head["version"]) if head["version"] else None,
            fat_uih=fat,
            context=context,
        )

    def payload_bytes(self, schema: ev.TraitSchema) -> int:
        return len(self.to_bytes(schema))
