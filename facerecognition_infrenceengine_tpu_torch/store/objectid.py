"""BSON-compatible ObjectId.

pymongo/bson are not available in this environment; the document store and
the REST API still speak ObjectId hex strings so that payloads stay
byte-compatible with the reference's MongoDB documents (e.g.
``str(result.inserted_id)`` in reference app/api/employee.py:159).
Layout follows the BSON spec: 4-byte big-endian timestamp, 5-byte process
random, 3-byte counter.
"""

from __future__ import annotations

import os
import struct
import threading
import time


class InvalidId(ValueError):
    pass


_lock = threading.Lock()
_counter = int.from_bytes(os.urandom(3), "big")
_random5 = os.urandom(5)


class ObjectId:
    __slots__ = ("_bytes",)

    def __init__(self, oid: "ObjectId | str | bytes | None" = None):
        global _counter
        if oid is None:
            with _lock:
                _counter = (_counter + 1) % 0x1000000
                count = _counter
            self._bytes = (
                struct.pack(">I", int(time.time())) + _random5
                + count.to_bytes(3, "big")
            )
        elif isinstance(oid, ObjectId):
            self._bytes = oid._bytes
        elif isinstance(oid, bytes):
            if len(oid) != 12:
                raise InvalidId(f"ObjectId must be 12 bytes, got {len(oid)}")
            self._bytes = oid
        elif isinstance(oid, str):
            if len(oid) != 24:
                raise InvalidId(f"'{oid}' is not a valid ObjectId")
            try:
                self._bytes = bytes.fromhex(oid)
            except ValueError as e:
                raise InvalidId(f"'{oid}' is not a valid ObjectId") from e
        else:
            raise InvalidId(f"cannot make ObjectId from {type(oid)}")

    @property
    def binary(self) -> bytes:
        return self._bytes

    @property
    def generation_time(self) -> float:
        return struct.unpack(">I", self._bytes[:4])[0]

    @classmethod
    def is_valid(cls, oid) -> bool:
        try:
            cls(oid)
            return True
        except (InvalidId, TypeError):
            return False

    def __str__(self) -> str:
        return self._bytes.hex()

    def __repr__(self) -> str:
        return f"ObjectId('{self._bytes.hex()}')"

    def __eq__(self, other) -> bool:
        if isinstance(other, ObjectId):
            return self._bytes == other._bytes
        return NotImplemented

    def __ne__(self, other) -> bool:
        if isinstance(other, ObjectId):
            return self._bytes != other._bytes
        return NotImplemented

    def __lt__(self, other):
        if isinstance(other, ObjectId):
            return self._bytes < other._bytes
        return NotImplemented

    def __gt__(self, other):
        if isinstance(other, ObjectId):
            return self._bytes > other._bytes
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._bytes)
