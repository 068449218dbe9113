"""Chunking + integrity (paper §6: objects are split into ~equal small chunks
so many read/write ops can run in parallel against the object stores).
(The port's copy of ``repro/transfer/chunk.py``.)"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib


@dataclasses.dataclass(frozen=True)
class Chunk:
    object_key: str
    index: int
    offset: int
    length: int

    @property
    def id(self) -> str:
        return f"{self.object_key}#{self.index}"


def chunk_object(object_key: str, size_bytes: int, chunk_bytes: int) -> list[Chunk]:
    chunks = []
    off = 0
    i = 0
    while off < size_bytes:
        ln = min(chunk_bytes, size_bytes - off)
        chunks.append(Chunk(object_key, i, off, ln))
        off += ln
        i += 1
    return chunks


def checksum(data: bytes, *, strong: bool = False) -> str:
    if strong:
        return hashlib.sha256(data).hexdigest()
    return f"{zlib.crc32(data):08x}"


def chunk_manifest(
    store, keys: list[str], chunk_bytes: int, *, with_sums: bool = True
) -> tuple[list[Chunk], dict[str, str], dict[str, str]]:
    """Chunk every object and checksum each chunk and whole object.

    The per-chunk sums are what make resume cheap: a destination can verify
    and commit chunks independently, re-requesting only the ones that failed
    — never re-reading bytes it already verified. Each object is read once:
    the object checksum is the CRC stream of the same chunk buffers.

    Returns (chunks, chunk_sums by Chunk.id, object_sums by key); the sum
    dicts are empty when ``with_sums`` is false.
    """
    chunks: list[Chunk] = []
    chunk_sums: dict[str, str] = {}
    object_sums: dict[str, str] = {}
    for key in keys:
        parts = chunk_object(key, store.size(key), chunk_bytes)
        chunks.extend(parts)
        if with_sums:
            running = 0
            for ch in parts:
                data = store.get_range(key, ch.offset, ch.length)
                chunk_sums[ch.id] = checksum(data)
                running = zlib.crc32(data, running)
            object_sums[key] = f"{running:08x}"
    return chunks, chunk_sums, object_sums
