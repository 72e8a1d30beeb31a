"""Host-side document store: compressed JSON blobs + pointer arrays.

Mirrors the reference doc store semantics (reference seekstorm/src/
doc_store.rs:31-103 — per-level pointer array + per-doc compressed JSON,
codec dispatch).  Documents never touch the TPU; fetch/highlighting is
host work.  Zlib is the always-available codec; zstd/lz4/snappy are used
when the corresponding python modules exist.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

from .schema import DocumentCompression

try:  # optional codecs
    import zstandard as _zstd  # type: ignore
except Exception:  # pragma: no cover
    _zstd = None
try:
    import lz4.frame as _lz4  # type: ignore
except Exception:  # pragma: no cover
    _lz4 = None
try:
    import snappy as _snappy  # type: ignore
except Exception:  # pragma: no cover
    _snappy = None


def _native_lz4_ok() -> bool:
    from . import native as _native

    return _native.load() is not None


def resolve_codec(codec: DocumentCompression) -> DocumentCompression:
    """LZ4 is always real: the in-repo C++ block codec
    (native/seekstorm_native.cpp st_lz4_*, format-compatible with the
    reference's lz4_flex framing) serves it when the python lz4 module is
    absent.  Zstd/Snappy degrade to Zlib when their modules are missing."""
    if codec == DocumentCompression.Zstd and _zstd is None:
        return DocumentCompression.Zlib
    if codec == DocumentCompression.Lz4 and _lz4 is None \
            and not _native_lz4_ok():
        return DocumentCompression.Zlib
    if codec == DocumentCompression.Snappy and _snappy is None:
        return DocumentCompression.Zlib
    return codec


def compress_doc(doc: dict, codec: DocumentCompression) -> bytes:
    raw = json.dumps(doc, ensure_ascii=False, separators=(",", ":")).encode("utf-8")
    codec = resolve_codec(codec)
    if codec == DocumentCompression.Null:
        return raw
    if codec == DocumentCompression.Zlib:
        return zlib.compress(raw, 1)
    if codec == DocumentCompression.Zstd:
        return _zstd.ZstdCompressor(level=1).compress(raw)
    if codec == DocumentCompression.Lz4:
        from . import native as _native

        out = _native.lz4_compress(raw)
        if out is not None:
            return out
        return _lz4.compress(raw)
    if codec == DocumentCompression.Snappy:
        return _snappy.compress(raw)
    raise ValueError(codec)


def decompress_doc(blob: bytes, codec: DocumentCompression) -> dict:
    codec = resolve_codec(codec)
    if codec == DocumentCompression.Null:
        raw = blob
    elif codec == DocumentCompression.Zlib:
        raw = zlib.decompress(blob)
    elif codec == DocumentCompression.Zstd:
        raw = _zstd.ZstdDecompressor().decompress(blob)
    elif codec == DocumentCompression.Lz4:
        from . import native as _native

        raw = _native.lz4_decompress(blob)
        if raw is None:
            raw = _lz4.decompress(blob)
    elif codec == DocumentCompression.Snappy:
        raw = _snappy.decompress(blob)
    else:
        raise ValueError(codec)
    return json.loads(raw)


class LevelDocStore:
    """Immutable per-level doc store (docs.bin + docptr.npy)."""

    def __init__(self, path: Path, codec: DocumentCompression, mmap: bool):
        self.path = path
        self.codec = codec
        self.ptr = np.load(path / "docptr.npy", mmap_mode="r" if mmap else None)
        if mmap:
            self._data = np.memmap(path / "docs.bin", dtype=np.uint8, mode="r")
        else:
            self._data = np.fromfile(path / "docs.bin", dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.ptr) - 1

    def get(self, local_id: int) -> dict:
        a, b = int(self.ptr[local_id]), int(self.ptr[local_id + 1])
        return decompress_doc(bytes(self._data[a:b]), self.codec)

    @staticmethod
    def write(path: Path, blobs: list[bytes]) -> None:
        ptr = np.zeros(len(blobs) + 1, dtype=np.int64)
        sizes = np.fromiter((len(b) for b in blobs), dtype=np.int64, count=len(blobs))
        np.cumsum(sizes, out=ptr[1:])
        with open(path / "docs.bin", "wb") as f:
            for b in blobs:
                f.write(b)
        np.save(path / "docptr.npy", ptr)
