"""TensorBoard event-file writer, dependency-free; copy of
`boxer_tpu/utils/tb_writer.py`.

Re-creates the reference's `TensorboardLogger.add_scalars`
(`e2edet/utils/logger.py:130-169`) without tensorboard/tensorflow: scalar
`Event` protos are hand-encoded (the schema is tiny — wall_time, step, and
Summary.Value{tag, simple_value}) and framed in the TFRecord format
(length + masked-crc32c(length) + data + masked-crc32c(data)), which is what
`tensorboard --logdir` reads.
"""

import os
import socket
import struct
import time
from typing import Dict, Optional

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, data: bytes) -> bytes:
    return _field(num, 2) + _varint(len(data)) + data


def _double_field(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float_field(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _varint_field(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: Optional[float] = None) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    val = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    summary = _bytes_field(1, val)                       # Summary.value = 1
    # Event: wall_time=1 (double), step=2 (int64), summary=5
    return (_double_field(1, wall_time or time.time())
            + _varint_field(2, int(step))
            + _bytes_field(5, summary))


def _file_version_event() -> bytes:
    # Event.file_version = 3 (string)
    return (_double_field(1, time.time())
            + _bytes_field(3, b"brain.Event:2"))


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


class TensorboardWriter:
    """Minimal `tf.summary`-compatible scalar writer."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%d.%s" % (int(time.time()),
                                               socket.gethostname())
        self._f = open(os.path.join(logdir, fname), "ab")
        self._f.write(_record(_file_version_event()))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(_record(_scalar_event(tag, value, step)))

    def add_scalars(self, scalars: Dict[str, float], step: int):
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)
        self._f.flush()

    def close(self):
        self._f.close()
