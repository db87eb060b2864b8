"""Structured telemetry sinks: JSONL, TensorBoard, fan-out; counterpart of
the JAX package's ``telemetry/sinks.py``, pure Python and copied from it.

* :class:`JSONLSink` — one JSON object a line; the first line is a
  ``{"provenance": ...}`` header (``utils.logging.run_provenance``).
  Rank 0 only by default (the ``torch.distributed`` rank).
* :class:`TensorBoardSink` — a dependency-free TensorBoard scalar writer:
  it encodes the Event and Summary protobufs and the TFRecord framing
  (masked CRC32C) by hand. Numeric record fields become scalar tags.
* :class:`MultiSink` — fan-out to several sinks.

All sinks are context managers; ``close()`` is idempotent.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Any, Mapping, Optional

__all__ = ["Sink", "JSONLSink", "TensorBoardSink", "MultiSink"]


def _is_rank_zero() -> bool:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _jsonable(value: Any) -> Any:
    if hasattr(value, "item"):     # numpy / torch scalars
        try:
            return value.item()
        except Exception:
            pass
    return str(value)


def _retry_io(fn, what: str):
    """``checkpoint._retry_io``: the bounded-backoff retry of transient
    ``OSError``s that ``Checkpointer.save`` uses, so an NFS blip cannot
    drop the last window of records."""
    from grace_tpu_torch.checkpoint import _retry_io as retry
    return retry(fn, what)


class Sink:
    """Minimal structured-record sink contract."""

    def write(self, record: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class JSONLSink(Sink):
    """Append-mode JSONL writer with a provenance header line.

    The header is written lazily on the first record so constructing the
    sink never touches the filesystem (a run that records nothing leaves
    nothing behind). ``rank_zero_only=True`` (default) makes non-zero
    processes no-ops.

    Durability: every record is written whole + flushed under the
    checkpoint save path's bounded-backoff ``_retry_io``, and ``close()``
    fsyncs before releasing the fd — a chaos-killed or preempted run
    leaves at worst a missing tail record, never a truncated mid-line one
    (the timeline loader still skips a torn line defensively, but it
    should never see one from this writer).
    """

    def __init__(self, path: str | os.PathLike,
                 provenance: Optional[Mapping[str, Any]] = None,
                 rank_zero_only: bool = True):
        self.path = os.fspath(path)
        self._prov = dict(provenance) if provenance is not None else None
        self._rank_zero_only = rank_zero_only
        self._file = None
        self._closed = False

    def _ensure_open(self) -> bool:
        if self._closed:
            raise ValueError(f"JSONLSink({self.path}) is closed")
        if self._rank_zero_only and not _is_rank_zero():
            return False
        if self._file is None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._file = open(self.path, "a")
            if self._prov is not None and self._file.tell() == 0:
                self._emit({"provenance": self._prov})
        return True

    def _emit(self, obj: Mapping[str, Any]) -> None:
        line = json.dumps(obj, default=_jsonable) + "\n"

        def write():
            self._file.write(line)
            self._file.flush()

        _retry_io(write, f"telemetry record -> {self.path}")

    def write(self, record: Mapping[str, Any]) -> None:
        if self._ensure_open():
            self._emit(dict(record))

    def close(self) -> None:
        if self._file is not None:
            try:
                _retry_io(lambda: (self._file.flush(),
                                   os.fsync(self._file.fileno())),
                          f"fsync {self.path}")
            finally:
                self._file.close()
                self._file = None
        self._closed = True


# ---------------------------------------------------------------------------
# TensorBoard event-file encoding (no TF / tensorboardX dependency)
# ---------------------------------------------------------------------------

def _crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset CRC32C mask."""
    crc = crc32c(data)
    return (((crc >> 15) | ((crc << 17) & 0xFFFFFFFF)) + 0xA282EAD8) \
        & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    # Event proto: wall_time=1 (double), step=2 (int64),
    # file_version=3 (string), summary=5 (message).
    buf = _pb_key(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        buf += _pb_key(2, 0) + _varint(int(step))
    if file_version is not None:
        buf += _pb_len(3, file_version.encode())
    if summary is not None:
        buf += _pb_len(5, summary)
    return buf


def _scalar_summary(tags_values) -> bytes:
    # Summary proto: repeated Value value=1; Value: tag=1 (string),
    # simple_value=2 (float).
    buf = b""
    for tag, value in tags_values:
        val = _pb_len(1, tag.encode()) \
            + _pb_key(2, 5) + struct.pack("<f", float(value))
        buf += _pb_len(1, val)
    return buf


def _framed(event: bytes) -> bytes:
    header = struct.pack("<Q", len(event))
    return (header + struct.pack("<I", masked_crc(header))
            + event + struct.pack("<I", masked_crc(event)))


class TensorBoardSink(Sink):
    """Write scalar records as a TensorBoard events file, pure Python.

    Every numeric field of a record becomes a scalar under
    ``<tag_prefix>/<field>``; the record's ``"step"`` field (required,
    else a running counter) becomes the global step. String/None fields
    are skipped — TensorBoard scalars are floats.
    """

    def __init__(self, logdir: str | os.PathLike, tag_prefix: str = "grace",
                 rank_zero_only: bool = True):
        self.logdir = os.fspath(logdir)
        self.tag_prefix = tag_prefix
        self._rank_zero_only = rank_zero_only
        self._file = None
        self._auto_step = 0

    def _ensure_open(self) -> bool:
        if self._rank_zero_only and not _is_rank_zero():
            return False
        if self._file is None:
            os.makedirs(self.logdir, exist_ok=True)
            name = (f"events.out.tfevents.{int(time.time())}."
                    f"{socket.gethostname()}.{os.getpid()}.v2")
            self._file = open(os.path.join(self.logdir, name), "wb")
            self._file.write(_framed(_event(time.time(),
                                            file_version="brain.Event:2")))
            self._file.flush()
        return True

    def write(self, record: Mapping[str, Any]) -> None:
        if not self._ensure_open():
            return
        step = record.get("step")
        if step is None:
            step, self._auto_step = self._auto_step, self._auto_step + 1
        scalars = []
        for key, value in record.items():
            if key == "step":
                continue
            if isinstance(value, bool):
                value = float(value)
            if hasattr(value, "item"):
                try:
                    value = value.item()
                except Exception:
                    continue
            if isinstance(value, (int, float)):
                scalars.append((f"{self.tag_prefix}/{key}", value))
        if not scalars:
            return
        self._file.write(_framed(_event(
            time.time(), step=int(step),
            summary=_scalar_summary(scalars))))
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class MultiSink(Sink):
    """Fan a record out to several sinks; close closes them all."""

    def __init__(self, *sinks: Sink):
        self.sinks = tuple(sinks)

    def write(self, record: Mapping[str, Any]) -> None:
        for sink in self.sinks:
            sink.write(record)

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()
