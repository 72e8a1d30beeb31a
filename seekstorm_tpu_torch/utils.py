"""Host-side utilities: term hashing, Lucene SmallFloat doc-length compression.

The doc-length compression follows the public Lucene SmallFloat (intToByte4 /
byte4ToInt) algorithm, which the reference also uses for its
DOCUMENT_LENGTH_COMPRESSION table (reference index.rs:4237-4279).
"""

from __future__ import annotations

import numpy as np
from bisect import bisect_right as _bisect_right

_FNV64_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV64_PRIME = np.uint64(0x100000001B3)


def term_hash(term: str) -> int:
    """Stable 64-bit FNV-1a hash of a (utf-8) term.

    The reference hashes terms with gxhash/ahash (index.rs:4165-4222); any
    stable 64-bit hash with negligible collision rate works — the term
    dictionary maps hash -> posting segments.
    """
    h = 0xCBF29CE484222325
    for b in term.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def term_hashes(terms: list[str]) -> np.ndarray:
    return np.array([term_hash(t) for t in terms], dtype=np.uint64)


NUM_FREE_VALUES = 24


def int_to_byte4(i: int) -> int:
    """Lossy u32 -> u8 log-ish compression (Lucene SmallFloat.intToByte4)."""
    if i < NUM_FREE_VALUES:
        return i
    ii = i - NUM_FREE_VALUES
    num_bits = ii.bit_length()
    if num_bits < 4:
        return NUM_FREE_VALUES + ii
    shift = num_bits - 4
    return NUM_FREE_VALUES + (((ii >> shift) & 0x07) | ((shift + 1) << 3))


def byte4_to_int(b: int) -> int:
    if b < NUM_FREE_VALUES:
        return b
    i = b - NUM_FREE_VALUES
    bits = i & 0x07
    shift = i >> 3
    if shift == 0:
        return NUM_FREE_VALUES + bits
    return NUM_FREE_VALUES + ((bits | 0x08) << (shift - 1))


# 256-entry decompression table
DOCUMENT_LENGTH_COMPRESSION = np.array(
    [byte4_to_int(b) for b in range(256)], dtype=np.uint32
)

# u32 length -> compressed byte, vectorized via searchsorted on the (monotone
# non-decreasing) decompression table: pick the largest byte whose decompressed
# value is <= the clamped representable value below the input.  intToByte4
# truncates (floors) the mantissa, so the mapping is: byte b such that
# table[b] <= i < table[b+1].
_TABLE = DOCUMENT_LENGTH_COMPRESSION.astype(np.int64)


def compress_lengths(lengths: np.ndarray) -> np.ndarray:
    """Vectorized intToByte4 over an array of non-negative ints."""
    li = np.asarray(lengths, dtype=np.int64)
    li = np.clip(li, 0, int(_TABLE[-1]))
    idx = np.searchsorted(_TABLE, li, side="right") - 1
    return idx.astype(np.uint8)


def compress_lengths_bytes(lengths: list) -> bytes:
    """Scalar intToByte4 over a short list (per-doc ingest hot path — the
    numpy version costs more than the C tokenizer call for 2-field docs)."""
    return bytes(
        _bisect_right(_TABLE_LIST, min(max(int(v), 0), _TABLE_MAX)) - 1
        for v in lengths
    )


def ceil_pow2(n: int, minimum: int = 1) -> int:
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def ceil_ladder(n: int, m: int = 16) -> int:
    """Round up to m * {1, 2, 3} * 2^k — a denser shape-bucketing ladder
    than pow2 (max padding waste 1.5x instead of 2x; ~1.7x more compiled
    shapes).  Used for scan-step counts, where padded steps pay full
    kernel cost."""
    q = max(-(-int(n) // m), 1)
    best = None
    for b in (1, 2, 3):
        k = 0
        while (b << k) < q:
            k += 1
        v = b << k
        best = v if best is None else min(best, v)
    return best * m


def ngram_virtual_hash(h: int, j: int) -> int:
    """Synthetic directory hash for the j-th constituent-impact segment of an
    n-gram posting list (j >= 2; constituent 1 reuses the n-gram's own hash).

    Under Bm25f, n-gram postings are scored with per-constituent tfs and idfs
    (reference add_result.rs:868-915 stores constituent tfs in the n-gram
    posting; here each constituent gets its own virtual posting segment so
    the scoring kernel stays unchanged)."""
    return (h * 0x9E3779B97F4A7C15 + j * 0xA24BAED4963EE407 + 0x1F0E) \
        & 0xFFFFFFFFFFFFFFFF


_TABLE_LIST = _TABLE.tolist()
_TABLE_MAX = int(_TABLE[-1])
DLC_LIST = DOCUMENT_LENGTH_COMPRESSION.tolist()


def ceil_pow4(n: int, minimum: int = 1) -> int:
    """Round up to minimum * 4^i (coarse shape bucketing for compile reuse)."""
    b = minimum
    n = int(n)
    while b < n:
        b *= 4
    return b
