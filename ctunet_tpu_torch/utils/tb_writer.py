"""Dependency-free TensorBoard scalar event writer.

The reference logs scalars through torch's ``SummaryWriter``
(``ctunet/pytorch/Model.py:138``), which needs the ``tensorboard`` package.
The port needs no package beyond torch and numpy, so this module (its own
copy of ``ctunet_tpu/utils/tb_writer.py``) writes the tfevents wire format
directly:

- a tfevents file is a TFRecord stream: ``uint64 length | uint32
  masked_crc32c(length) | payload | uint32 masked_crc32c(payload)``;
- each payload is a serialized ``tensorflow.Event`` protobuf — hand-encoded
  here (the scalar subset needs only varints, one double, one float and two
  length-delimited fields);
- the first record is the ``file_version = "brain.Event:2"`` header event.

Output is readable by stock TensorBoard; the tests read it back with
:func:`read_scalars` and with the JAX package's reader.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional


def _make_crc_table():
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    assert n >= 0
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (strings / embedded messages)."""
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(step: int, wall_time: float, body: bytes = b"") -> bytes:
    return (
        _key(1, 1) + struct.pack("<d", wall_time)   # Event.wall_time
        + _key(2, 0) + _varint(max(0, int(step)))   # Event.step
        + body
    )


def _scalar_summary(tag: str, value: float) -> bytes:
    val = (
        _ld(1, tag.encode("utf-8"))                   # Value.tag
        + _key(2, 5) + struct.pack("<f", float(value))  # Value.simple_value
    )
    return _ld(5, _ld(1, val))  # Event.summary -> Summary.value


class EventsWriter:
    """Minimal append-only tfevents file for scalar summaries."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()), socket.gethostname(), filename_suffix
        )
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        # header record: file_version = "brain.Event:2"
        self._write(_event(0, time.time(), _ld(3, b"brain.Event:2")))
        self._f.flush()

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(step, time.time(), _scalar_summary(tag, value)))
        # scalars arrive at epoch granularity — flush each so live
        # TensorBoard (and a crash) always sees the latest epoch
        self._f.flush()

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_scalars(path: str):
    """Decode a tfevents file written by :class:`EventsWriter` back into
    ``{tag: [(step, value), ...]}`` — CRC-checked. Test/debug helper (and
    the fallback reader for environments without tensorboard)."""
    out: dict = {}
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "header CRC mismatch"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "payload CRC mismatch"
            step, tag, value = _parse_event(payload)
            if tag is not None:
                out.setdefault(tag, []).append((step, value))
    return out


def _parse_event(buf: bytes):
    step, tag, value = 0, None, None
    i = 0

    def varint():
        nonlocal i
        n, shift = 0, 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    while i < len(buf):
        k = varint()
        field, wire = k >> 3, k & 7
        if wire == 0:
            v = varint()
            if field == 2:
                step = v
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 2:
            ln = varint()
            sub = buf[i:i + ln]
            i += ln
            if field == 5:  # summary
                tag, value = _parse_summary(sub)
    return step, tag, value


def _parse_summary(buf: bytes):
    # Summary { repeated Value value = 1 }; Value { tag=1, simple_value=2 }
    i = 0

    def varint():
        nonlocal i
        n, shift = 0, 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    tag, value = None, None
    while i < len(buf):
        k = varint()
        field, wire = k >> 3, k & 7
        if wire == 2:
            ln = varint()
            sub = buf[i:i + ln]
            i += ln
            if field == 1:
                j = 0
                while j < len(sub):
                    kk = sub[j]
                    j += 1
                    f2, w2 = kk >> 3, kk & 7
                    if f2 == 1 and w2 == 2:
                        ln2 = sub[j]
                        j += 1
                        tag = sub[j:j + ln2].decode("utf-8")
                        j += ln2
                    elif f2 == 2 and w2 == 5:
                        (value,) = struct.unpack("<f", sub[j:j + 4])
                        j += 4
                    elif w2 == 0:
                        while sub[j] & 0x80:
                            j += 1
                        j += 1
                    else:
                        break
        elif wire == 0:
            varint()
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
    return tag, value


_warned: set = set()


def make_writer(logdir: Optional[str]):
    """Writer factory for the trainer: native :class:`EventsWriter`, or
    None (with a loud one-time warning) when the directory cannot be
    created: never a silent no-op."""
    if not logdir:
        return None
    try:
        return EventsWriter(logdir)
    except OSError as e:  # pragma: no cover - unwritable logdir
        if logdir not in _warned:
            _warned.add(logdir)
            print(
                f"WARNING: TensorBoard logging DISABLED — cannot write to "
                f"{logdir!r}: {e}"
            )
        return None
