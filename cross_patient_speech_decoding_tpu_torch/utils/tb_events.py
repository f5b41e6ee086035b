"""Minimal TensorBoard event-file writer (scalars only, zero deps).

The reference trains under Lightning's ``TensorBoardLogger`` with
context-encoded run names (`train_ctc_rnn.py:235-261`), so a user can
watch a 50-iteration run live with ``tensorboard --logdir``. The rebuild
logs CSV/JSONL by default; this module closes the live-monitoring gap
with a self-contained encoder for the TFRecord-framed ``Event`` protobuf
(no tensorflow/torch import in the hot path — a SummaryWriter import
costs seconds and a pile of threads per fold).

Format notes (both stable public formats):
- TFRecord framing: ``uint64 len | masked_crc32c(len) | payload |
  masked_crc32c(payload)``; mask = ``((c >> 15 | c << 17) + 0xa282ead8)``.
- ``Event`` proto fields: 1 wall_time (double), 2 step (int64),
  3 file_version (string, first record ``brain.Event:2``),
  5 summary (message); ``Summary.Value``: 1 tag (string),
  2 simple_value (float).

The port's copy of ``cross_patient_speech_decoding_tpu/utils/
tb_events.py``, in pure Python: a file it writes is byte for byte the JAX
package's for the same clock, host name and process id.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c ----

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------- proto encoding ----


def _varint(n: int) -> bytes:
    # protobuf int64 semantics: negatives encode as 64-bit two's
    # complement (10-byte varint) — without this, Python's arithmetic
    # right shift never reaches 0 and the loop would hang
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _pb_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict | None = None) -> bytes:
    msg = _pb_double(1, wall_time)
    if step is not None:
        msg += _pb_varint(2, step)
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_float(2, float(v)))
            for tag, v in scalars.items()
        )
        msg += _pb_bytes(5, summary)
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


# ---------------------------------------------------------------- writer ----


class TBEventWriter:
    """Appends scalar events to one ``events.out.tfevents.*`` file.

    Stateless across processes: re-opening the same logdir creates a new
    event file (TensorBoard merges files within a run directory by
    timestamp), so kill-and-resume runs remain readable.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, fname)
        with open(self.path, "ab") as f:
            f.write(_record(_event(time.time(),
                                   file_version="brain.Event:2")))

    def add_scalars(self, step: int, scalars: dict):
        with open(self.path, "ab") as f:
            f.write(_record(_event(time.time(), step=step,
                                   scalars=scalars)))


_WRITERS: dict[str, TBEventWriter] = {}


def tb_writer(logdir: str) -> TBEventWriter:
    """Per-process writer cache: one event file per logdir per process
    (fit() appends per epoch; re-creating files per append would litter
    thousands of tiny files)."""
    w = _WRITERS.get(logdir)
    if w is None or not os.path.exists(w.path):
        w = _WRITERS[logdir] = TBEventWriter(logdir)
    return w
