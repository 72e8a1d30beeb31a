"""ctypes bindings for the native host library (native/seekstorm_native.cpp):
tokenizer + level-0 posting accumulator.

Falls back to the pure-Python path when the shared library does not build
or load.  The library is the one the JAX package loads, built from the
repository's `native/` sources on first use.  The build never runs the
table generators (`native/gen_*.py` import the JAX package): it compiles
from the generated headers the repository tracks, and raises when one of
them is missing.

Several processes may need the library at once (test workers, a server
beside a script), and the JAX package's loader may run `make` in `native/`
at the same time.  So the port builds under a file lock, in a private copy
of the sources, and moves the finished library into `native/` in one
rename; a build that fails is retried, and a library another process
finished meanwhile is taken (see build_library).
"""

from __future__ import annotations

import ctypes as C
import os
import shutil
import time
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_TOKENIZER_IDS = {
    "AsciiAlphabetic": 0,
    "UnicodeAlphanumeric": 1,
    "UnicodeAlphanumericFolded": 2,
    "Whitespace": 3,
    "WhitespaceLowercase": 4,
    "UnicodeAlphanumericZH": 5,
}
# C++ tokenizer stemmer support: None, English/Porter (porter_stem), and
# the Snowball ports in native/snowball.cpp (ids >= 2, byte-exact vs NLTK;
# validated in tests/test_stemmers.py).  Languages NOT in this map run the
# Python ingest path — index.py gates _native on it.
_STEMMER_IDS = {
    "None": 0, "English": 1, "Porter": 1,
    # byte-exact Snowball ports (native/snowball.cpp)
    "Danish": 2, "Norwegian": 3, "Swedish": 4, "German": 5, "Dutch": 6,
    "DutchPorter": 6, "French": 7, "Spanish": 8, "Italian": 9,
    "Portuguese": 10, "Romanian": 11, "Russian": 12, "Finnish": 13,
    "Hungarian": 14, "Arabic": 15,
    # light-tier ports (native/light_stemmers.cpp; tables generated from
    # stemmers.py, byte-identical to the Python implementations)
    "Armenian": 16, "Basque": 17, "Catalan": 18, "Czech": 19,
    "Esperanto": 20, "Estonian": 21, "Greek": 22, "Hindi": 23,
    "Indonesian": 24, "Irish": 25, "Lithuanian": 26, "Lovins": 27,
    "Nepali": 28, "Persian": 29, "Polish": 30, "Serbian": 31,
    "Sesotho": 32, "Tamil": 33, "Turkish": 34, "Ukrainian": 35,
    "Yiddish": 36,
}


def stemmer_supported(stemmer_value: str) -> bool:
    """True when the C++ ingest fast path implements this stemmer."""
    lid = _STEMMER_IDS.get(stemmer_value, -1)
    if lid < 0:
        return False
    if lid < 2:
        return True
    lib = load()
    return lib is not None and bool(lib.st_snowball_has(lid))


def snowball_stem_fn(stemmer_value: str):
    """Per-word ctypes wrapper over the native stemmer for one language,
    or None when unavailable.  Snowball ids (< 16) lowercase first — the
    NLTK stem() entry points they mirror call word.lower() internally, so
    those callables are drop-ins for an NLTK stemmer's .stem.  Light-tier
    ids (>= 16) apply their rules to the token as-is, exactly like the
    Python implementations in stemmers.py."""
    lid = _STEMMER_IDS.get(stemmer_value, -1)
    lib = load()
    if lib is None or lid < 2 or not lib.st_snowball_has(lid):
        return None

    def stem(word: str, _lid=lid, _lib=lib) -> str:
        # Snowball ids (<16) lowercase first (the NLTK stem() entry
        # points they mirror do); light-tier ids apply rules to the
        # token as-is, like their Python implementations
        w = word.lower() if _lid < 16 else word
        n = len(w)
        cap = 2 * n + 8
        buf = (C.c_uint32 * cap)()
        for i, ch in enumerate(w):
            buf[i] = ord(ch)
        m = _lib.st_snowball_stem(_lid, buf, n, cap)
        if m < 0:
            return w
        return "".join(chr(buf[i]) for i in range(m))

    return stem


# generated from the JAX package by native/gen_*.py and tracked in git
_TABLES = ("unicode_tables.h", "light_stemmer_tables.h")


def make_command(native_dir: Path) -> list[str]:
    """The make invocation that builds the library in `native_dir` from the
    tracked headers: `-o` takes each header as it is, so make never runs
    its generator.  Raises when a header is missing."""
    missing = [h for h in _TABLES if not (native_dir / h).exists()]
    if missing:
        raise RuntimeError(
            f"{native_dir / missing[0]} is missing: the native library "
            "builds from the generated headers tracked in the repository")
    return (["make", "-C", str(native_dir)]
            + [a for h in _TABLES for a in ("-o", h)]
            + ["libseekstorm_native.so"])


_SOURCES = ("Makefile", "seekstorm_native.cpp", "snowball.cpp",
            "light_stemmers.cpp") + _TABLES
_LIB_NAME = "libseekstorm_native.so"


def build_library(native_dir: Path) -> Path | None:
    """`native_dir`'s library, built first if it is missing; None if it
    cannot be built.

    Callers in the port exclude each other by a lock file beside the
    sources, so the library is built once.  The build runs make_command in
    a private copy of the sources and renames the result into place, so it
    never shares the Makefile's temporary output with a concurrent `make`
    in `native_dir` (the JAX package's loader runs one).  A failed build is
    retried: a header read while that `make` regenerated it fails one
    compile, not the process's library for good."""
    import fcntl
    import subprocess
    import tempfile

    out = native_dir / _LIB_NAME
    if out.exists():
        return out
    with open(native_dir / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(3):
            if out.exists():
                return out
            if attempt:
                time.sleep(1.0)
            with tempfile.TemporaryDirectory(dir=native_dir,
                                             prefix=".build-") as tmp:
                work = Path(tmp)
                for f in _SOURCES:
                    if (native_dir / f).exists():
                        shutil.copy2(native_dir / f, work / f)
                try:
                    subprocess.run(make_command(work), check=True,
                                   capture_output=True, timeout=300)
                    os.replace(work / _LIB_NAME, out)
                except (OSError, subprocess.SubprocessError):
                    continue
            return out
    return out if out.exists() else None


def _find_lib() -> Path | None:
    env = os.environ.get("SEEKSTORM_TPU_NATIVE_LIB")
    if env:
        return Path(env)
    here = Path(__file__).resolve().parent.parent / "native"
    if (here / "seekstorm_native.cpp").exists():
        # built on first use (the binary is not checked in)
        return build_library(here)
    p = here / _LIB_NAME
    return p if p.exists() else None


def load() -> C.CDLL | None:
    global _LIB, _TRIED
    # the kill switch is honored even after the library was cached —
    # tests (and operators chasing a native-path bug) flip it mid-process
    if os.environ.get("SEEKSTORM_TPU_NO_NATIVE"):
        return None
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = C.CDLL(str(path))
    except OSError:
        return None
    u8p = C.POINTER(C.c_uint8)
    u16p = C.POINTER(C.c_uint16)
    u64p = C.POINTER(C.c_uint64)
    i32p = C.POINTER(C.c_int32)
    i64p = C.POINTER(C.c_int64)

    lib.st_cfg_new.restype = C.c_void_p
    lib.st_cfg_new.argtypes = [C.c_int, C.c_int, C.c_int, u8p, C.c_int64,
                               u8p, C.c_int64, C.c_uint64, C.c_uint64]
    lib.st_cfg_free.argtypes = [C.c_void_p]
    lib.st_cfg_set_synonyms.argtypes = [C.c_void_p, u8p, C.c_int64]
    lib.st_accum_new.restype = C.c_void_p
    lib.st_accum_new.argtypes = [C.c_int]
    lib.st_accum_free.argtypes = [C.c_void_p]
    lib.st_accum_doc_count.restype = C.c_int
    lib.st_accum_doc_count.argtypes = [C.c_void_p]
    lib.st_accum_add_doc.restype = C.c_int
    lib.st_accum_add_doc.argtypes = [C.c_void_p, C.c_void_p, u8p, i64p, i32p]
    lib.st_accum_add_docs.restype = C.c_int
    lib.st_accum_add_docs.argtypes = [
        C.c_void_p, C.c_void_p, u8p, i64p, C.c_int32, i32p,
    ]
    lib.st_accum_stats.argtypes = [C.c_void_p, i64p, i64p, i64p]
    lib.st_accum_pack.argtypes = [C.c_void_p, u64p, i64p, u16p, u16p, u16p]
    lib.st_accum_terms_blob.restype = C.c_int64
    lib.st_accum_terms_blob.argtypes = [C.c_void_p, u8p, C.c_int64]
    lib.st_accum_dict_blob.restype = C.c_int64
    lib.st_accum_dict_blob.argtypes = [C.c_void_p, u8p, C.c_int64]
    lib.st_accum_completions_blob.restype = C.c_int64
    lib.st_accum_completions_blob.argtypes = [C.c_void_p, u8p, C.c_int64]
    lib.st_accum_clear_counts.argtypes = [C.c_void_p]
    lib.st_accum_load.argtypes = [C.c_void_p, u64p, i64p, u16p, u16p, u16p,
                                  u8p, C.c_int64, C.c_int64, C.c_int32]
    lib.st_accum_term_postings.restype = C.c_int64
    # buffers as addresses: a realtime batch makes one call a term, and
    # ndarray.ctypes.data_as costs more than the call
    lib.st_accum_term_postings.argtypes = [C.c_void_p, C.c_uint64,
                                           C.c_void_p, C.c_void_p, C.c_int64]
    lib.st_accum_term_doc_positions.restype = C.c_int64
    lib.st_accum_term_doc_positions.argtypes = [C.c_void_p, C.c_uint64,
                                                C.c_int32, u16p, u16p,
                                                C.c_int64]
    lib.st_tokenize_text.restype = C.c_int64
    lib.st_tokenize_text.argtypes = [C.c_void_p, u8p, C.c_int64, u8p,
                                     C.c_int64]
    lib.st_cfg_set_zh_dict.restype = C.c_int64
    lib.st_cfg_set_zh_dict.argtypes = [C.c_void_p, u8p, C.c_int64]
    lib.st_lz4_compress_bound.restype = C.c_int64
    lib.st_lz4_compress_bound.argtypes = [C.c_int64]
    lib.st_lz4_compress.restype = C.c_int64
    lib.st_lz4_compress.argtypes = [u8p, C.c_int64, u8p, C.c_int64]
    lib.st_lz4_decompress.restype = C.c_int64
    lib.st_lz4_decompress.argtypes = [u8p, C.c_int64, u8p, C.c_int64]
    u32p = C.POINTER(C.c_uint32)
    f32p = C.POINTER(C.c_float)
    lib.st_snowball_stem.restype = C.c_int
    lib.st_snowball_stem.argtypes = [C.c_int, u32p, C.c_int, C.c_int]
    lib.st_snowball_has.restype = C.c_int
    lib.st_snowball_has.argtypes = [C.c_int]
    lib.st_exact_eval.restype = C.c_int64
    lib.st_exact_eval.argtypes = [
        C.c_int, u32p, f32p, i64p, f32p, u8p, i32p, i64p,
        C.c_int, C.c_int64, i64p, i64p, u32p, f32p,
        C.c_int64, f32p, i64p, i64p,
    ]
    u64p = C.POINTER(C.c_uint64)
    lib.st_rescore.restype = None
    lib.st_rescore.argtypes = [
        C.c_int, u64p, u64p, i64p, f32p,
        C.c_int, i32p, u8p, i64p, i64p, i64p,
        i32p, i64p, C.c_int, C.c_int, i64p, i64p, u32p, f32p,
        C.c_int64, f32p, i64p, i64p, i64p,
    ]
    u16p2 = C.POINTER(C.c_uint16)
    lib.st_build_impacts.restype = None
    lib.st_build_impacts.argtypes = [
        C.c_int64, C.c_int, u16p2, u16p2, f32p, f32p,
        C.c_int64, i64p, C.c_int, C.c_float,
        f32p, f32p, u8p, i32p,
    ]
    lib.st_build_dev.restype = None
    lib.st_build_dev.argtypes = [
        C.c_int64, i64p, i32p, i32p, i32p,
        u16p2, f32p, u8p, f32p, C.c_int, C.c_int64,
        u16p2, f32p, i32p, u32p, i64p, i32p,
    ]
    lib.st_pack_postings.restype = C.c_int64
    lib.st_pack_postings.argtypes = [
        C.c_int64, i64p, u16p2, u16p2, C.c_int, u16p2, u8p, C.c_int64,
    ]
    lib.st_decode_postings.restype = None
    lib.st_decode_postings.argtypes = [
        u8p, C.c_int64, i64p, C.c_int, u16p2, u16p2, u16p2,
    ]
    _LIB = lib
    return lib


def _p(a, ct):
    import ctypes as _C

    return a.ctypes.data_as(_C.POINTER(ct))


def pack_postings(term_offset, docid, tf, pos):
    """Encode level postings to the compact durable byte stream
    (st_pack_postings; see native/seekstorm_native.cpp).  Returns bytes,
    or None when the native library is unavailable."""
    import ctypes as _C

    import numpy as np

    lib = load()
    if lib is None or not hasattr(lib, "st_pack_postings"):
        return None
    T = len(term_offset) - 1
    off = np.ascontiguousarray(term_offset, np.int64)
    did = np.ascontiguousarray(docid, np.uint16)
    tfa = np.ascontiguousarray(tf, np.uint16)
    poa = np.ascontiguousarray(pos, np.uint16)
    F = tfa.shape[1] if tfa.ndim == 2 else 1
    # single encode pass into a worst-case buffer: per posting <= 3 B
    # docid varint + 1 B mask + F * 3 B tf varints; <= 3 B per position
    cap = int(len(did)) * (4 + 3 * F) + int(poa.size) * 3 + 64
    out = np.zeros(cap, np.uint8)
    n = lib.st_pack_postings(
        T, _p(off, _C.c_int64), _p(did, _C.c_uint16), _p(tfa, _C.c_uint16),
        F, _p(poa, _C.c_uint16), _p(out, _C.c_uint8), cap)
    assert n >= 0, "st_pack_postings overflow (cap miscomputed)"
    return out[:n].tobytes()


def decode_postings(blob, term_offset, F, n_pos):
    """Decode the compact posting stream back to the fixed-width arrays
    (docid u16[P], tf u16[P, F], pos u16[n_pos]); None without the
    native library."""
    import ctypes as _C

    import numpy as np

    lib = load()
    if lib is None or not hasattr(lib, "st_decode_postings"):
        return None
    off = np.ascontiguousarray(term_offset, np.int64)
    T = len(off) - 1
    P = int(off[-1])
    buf = np.frombuffer(blob, np.uint8)
    docid = np.zeros(P, np.uint16)
    tf = np.zeros((P, F), np.uint16)
    pos = np.zeros(n_pos, np.uint16)
    lib.st_decode_postings(
        _p(buf, _C.c_uint8), T, _p(off, _C.c_int64), F,
        _p(docid, _C.c_uint16), _p(tf, _C.c_uint16), _p(pos, _C.c_uint16))
    return docid, tf, pos


def _ptr(a: np.ndarray, ctype):
    """ctypes pointer to a C-contiguous numpy array (empty -> NULL)."""
    if a.size == 0:
        return None
    return a.ctypes.data_as(C.POINTER(ctype))


def build_impacts(docid, tf, comp, boosts, term_offset, f_star, k1p1):
    """Fused per-level impact pass (st_build_impacts).  Returns
    (imp f32[P], max f32[T], plain u8[P], plain_cnt i32[T]) or None when
    the native library is unavailable (caller falls back to numpy)."""
    lib = load()
    if lib is None or not hasattr(lib, "st_build_impacts"):
        return None
    P, F = tf.shape
    T = len(term_offset) - 1
    docid = np.ascontiguousarray(docid, np.uint16)
    tf = np.ascontiguousarray(tf, np.uint16)
    comp = np.ascontiguousarray(comp, np.float32)
    boosts = np.ascontiguousarray(boosts, np.float32)
    term_offset = np.ascontiguousarray(term_offset, np.int64)
    imp = np.empty(P, np.float32)
    mx = np.empty(T, np.float32)
    plain = np.empty(P, np.uint8)
    pcnt = np.empty(T, np.int32)
    lib.st_build_impacts(
        P, F, _ptr(docid, C.c_uint16), _ptr(tf, C.c_uint16),
        _ptr(comp, C.c_float), _ptr(boosts, C.c_float),
        T, _ptr(term_offset, C.c_int64), f_star, C.c_float(k1p1),
        _ptr(imp, C.c_float), _ptr(mx, C.c_float),
        _ptr(plain, C.c_uint8), _ptr(pcnt, C.c_int32))
    return imp, mx, plain, pcnt


def build_dev(seg_off, seg_len, seg_block, seg_bitmap, pl_docid, pl_imp,
              plain, sat1, stash_k, csr_total, dev_total, n_bitmap_rows):
    """Fused directory-order device-layout pass (st_build_dev).  Returns
    (dev_docid, dev_imp, seg_dev_len, bitmaps, seg_stash_off,
    seg_stash_len) or None when the native library is unavailable."""
    lib = load()
    if lib is None or not hasattr(lib, "st_build_dev"):
        return None
    nseg = len(seg_off)
    seg_off = np.ascontiguousarray(seg_off, np.int64)
    seg_len = np.ascontiguousarray(seg_len, np.int32)
    seg_block = np.ascontiguousarray(seg_block, np.int32)
    seg_bitmap = np.ascontiguousarray(seg_bitmap, np.int32)
    pl_docid = np.ascontiguousarray(pl_docid, np.uint16)
    pl_imp = np.ascontiguousarray(pl_imp, np.float32)
    plain = np.ascontiguousarray(plain, np.uint8)
    sat1 = np.ascontiguousarray(sat1, np.float32)
    dev_docid = np.empty(dev_total, np.uint16)
    dev_imp = np.empty(dev_total, np.float32)
    seg_dev_len = np.empty(nseg, np.int32)
    bitmaps = np.zeros((n_bitmap_rows, 2048), np.uint32)
    seg_stash_off = np.zeros(nseg, np.int64)
    seg_stash_len = np.zeros(nseg, np.int32)
    lib.st_build_dev(
        nseg, _ptr(seg_off, C.c_int64), _ptr(seg_len, C.c_int32),
        _ptr(seg_block, C.c_int32), _ptr(seg_bitmap, C.c_int32),
        _ptr(pl_docid, C.c_uint16), _ptr(pl_imp, C.c_float),
        _ptr(plain, C.c_uint8), _ptr(sat1, C.c_float),
        stash_k, csr_total,
        _ptr(dev_docid, C.c_uint16), _ptr(dev_imp, C.c_float),
        _ptr(seg_dev_len, C.c_int32),
        bitmaps.ctypes.data_as(C.POINTER(C.c_uint32))
        if n_bitmap_rows else None,
        _ptr(seg_stash_off, C.c_int64), _ptr(seg_stash_len, C.c_int32))
    return (dev_docid, dev_imp, seg_dev_len, bitmaps, seg_stash_off,
            seg_stash_len)


def lz4_compress(raw: bytes) -> bytes | None:
    """LZ4 block compress with a u32-LE uncompressed-size prefix (the
    reference's lz4_flex compress_prepend_size framing)."""
    lib = load()
    if lib is None:
        return None
    import struct

    n = len(raw)
    cap = int(lib.st_lz4_compress_bound(n))
    dst = C.create_string_buffer(cap)
    m = lib.st_lz4_compress(
        _u8(raw), n, C.cast(dst, C.POINTER(C.c_uint8)), cap)
    if m < 0:
        return None
    return struct.pack("<I", n) + dst.raw[:m]


def lz4_decompress(blob: bytes) -> bytes | None:
    lib = load()
    if lib is None or len(blob) < 4:
        return None
    import struct

    n = struct.unpack("<I", blob[:4])[0]
    dst = C.create_string_buffer(max(n, 1))
    m = lib.st_lz4_decompress(
        _u8(blob[4:]), len(blob) - 4, C.cast(dst, C.POINTER(C.c_uint8)), n)
    if m != n:
        return None
    return dst.raw[:n]


def available() -> bool:
    return load() is not None


def _u8(b: bytes):
    return C.cast(C.c_char_p(b), C.POINTER(C.c_uint8))


def _arr(a: np.ndarray, ctype):
    return a.ctypes.data_as(C.POINTER(ctype))


class NativeConfig:
    """Wraps StCfg: analyzer + n-gram + synonym config for the accumulator."""

    def __init__(self, index):
        lib = load()
        self._lib = lib
        meta = index.meta
        stop = "\n".join(sorted(index.analyzer.stopwords)).encode()
        freq = "\n".join(sorted(index._frequent_words)).encode()
        dict_mask = 0
        for fid in index._dict_field_ids:
            dict_mask |= 1 << fid
        comp_mask = 0
        if index.completions is not None:
            for sf in index.indexed_fields:
                if sf.field in index._completion_fields:
                    comp_mask |= 1 << sf.indexed_field_id
        if index.spell is None:
            dict_mask = 0
        self._stop = stop
        self._freq = freq
        self.ptr = lib.st_cfg_new(
            _TOKENIZER_IDS[meta.tokenizer.value],
            _STEMMER_IDS[meta.stemmer.value],
            meta.ngram_indexing if index._frequent_words else 0,
            _u8(stop), len(stop), _u8(freq), len(freq),
            dict_mask, comp_mask,
        )
        self.set_synonyms(index._synonym_map)
        if meta.tokenizer.value == "UnicodeAlphanumericZH":
            # load the SAME frequency dictionary the query-time Python
            # analyzer resolves, so ingest and query tokenization agree
            from .word_segmentation import resolve_dict_path

            p = resolve_dict_path()
            if p is not None:
                blob = p.read_bytes()
                lib.st_cfg_set_zh_dict(self.ptr, _u8(blob), len(blob))

    def set_synonyms(self, syn_map: dict[str, set]) -> None:
        lib = self._lib
        blob = "\n".join(
            t + "\t" + "\t".join(sorted(s)) for t, s in syn_map.items()
        ).encode()
        self._syn = blob
        lib.st_cfg_set_synonyms(self.ptr, _u8(blob), len(blob))

    def tokenize(self, text: str) -> list[str]:
        lib = self._lib
        raw = text.encode()
        n = lib.st_tokenize_text(self.ptr, _u8(raw), len(raw), None, 0)
        if n <= 0:
            return []
        buf = np.zeros(n, np.uint8)
        lib.st_tokenize_text(self.ptr, _u8(raw), len(raw),
                             _arr(buf, C.c_uint8), n)
        return buf.tobytes().decode().split("\n")[:-1]

    def __del__(self):
        try:
            self._lib.st_cfg_free(self.ptr)
        except Exception:
            pass


class NativeAccumulator:
    """Wraps StAccum: the level-0 term/posting store in C++."""

    def __init__(self, n_fields: int):
        self.lib = load()
        self.n_fields = n_fields
        self.ptr = self.lib.st_accum_new(n_fields)

    def __del__(self):
        try:
            self.lib.st_accum_free(self.ptr)
        except Exception:
            pass

    def add_doc(self, cfg: NativeConfig, field_texts: list[bytes]) -> tuple[int, list]:
        """Hot path: reusable ctypes buffers, no numpy per call (the per-doc
        marshalling cost dominated single-core ingest)."""
        blob = b"".join(field_texts)
        offs = getattr(self, "_offs_buf", None)
        if offs is None:
            offs = self._offs_buf = (C.c_int64 * (self.n_fields + 1))()
            self._lens_buf = (C.c_int32 * self.n_fields)()
        o = 0
        for i, t in enumerate(field_texts):
            o += len(t)
            offs[i + 1] = o
        docid = self.lib.st_accum_add_doc(
            self.ptr, cfg.ptr, _u8(blob), offs, self._lens_buf,
        )
        return docid, list(self._lens_buf)

    def add_docs(
        self, cfg: NativeConfig, texts: list[bytes]
    ) -> tuple[int, list]:
        """Batch ingest: texts is n_docs*n_fields field byte strings in doc
        order; ONE C call tokenizes and accumulates all of them. Returns
        (first_docid, flat per-field token lengths)."""
        F = self.n_fields
        n_docs = len(texts) // F
        blob = b"".join(texts)
        offs = (C.c_int64 * (len(texts) + 1))()
        o = 0
        for i, t in enumerate(texts):
            o += len(t)
            offs[i + 1] = o
        lens = (C.c_int32 * len(texts))()
        first = self.lib.st_accum_add_docs(
            self.ptr, cfg.ptr, _u8(blob), offs, n_docs, lens,
        )
        return first, list(lens)

    def stats(self) -> tuple[int, int, int]:
        t = C.c_int64()
        p = C.c_int64()
        x = C.c_int64()
        self.lib.st_accum_stats(self.ptr, C.byref(t), C.byref(p), C.byref(x))
        return t.value, p.value, x.value

    def pack(self):
        T, P, X = self.stats()
        F = self.n_fields
        hashes = np.zeros(T, np.uint64)
        offsets = np.zeros(T + 1, np.int64)
        docids = np.zeros(P, np.uint16)
        tfs = np.zeros((P, F), np.uint16)
        positions = np.zeros(X, np.uint16)
        if T:
            self.lib.st_accum_pack(
                self.ptr, _arr(hashes, C.c_uint64), _arr(offsets, C.c_int64),
                _arr(docids, C.c_uint16), _arr(tfs, C.c_uint16),
                _arr(positions, C.c_uint16),
            )
        return hashes, offsets, docids, tfs, positions

    def terms_blob(self) -> bytes:
        n = self.lib.st_accum_terms_blob(self.ptr, None, 0)
        if n <= 0:
            return b""
        buf = np.zeros(n, np.uint8)
        self.lib.st_accum_terms_blob(self.ptr, _arr(buf, C.c_uint8), n)
        return buf.tobytes()

    def _counts_blob(self, fn) -> dict[str, int]:
        n = fn(self.ptr, None, 0)
        if n <= 0:
            return {}
        buf = np.zeros(n, np.uint8)
        m = fn(self.ptr, _arr(buf, C.c_uint8), n)
        out = {}
        for line in buf.tobytes()[:m].decode().splitlines():
            if "\t" in line:
                t, c = line.rsplit("\t", 1)
                out[t] = int(c)
        return out

    def drain_counts(self) -> tuple[dict, dict]:
        d = self._counts_blob(self.lib.st_accum_dict_blob)
        c = self._counts_blob(self.lib.st_accum_completions_blob)
        self.lib.st_accum_clear_counts(self.ptr)
        return d, c

    def load_packed(self, hashes, offsets, docids, tfs, positions,
                    terms_blob: bytes, doc_count: int) -> None:
        hashes = np.ascontiguousarray(hashes, np.uint64)
        offsets = np.ascontiguousarray(offsets, np.int64)
        docids = np.ascontiguousarray(docids, np.uint16)
        tfs = np.ascontiguousarray(tfs, np.uint16)
        positions = np.ascontiguousarray(positions, np.uint16)
        self.lib.st_accum_load(
            self.ptr, _arr(hashes, C.c_uint64), _arr(offsets, C.c_int64),
            _arr(docids, C.c_uint16), _arr(tfs, C.c_uint16),
            _arr(positions, C.c_uint16), _u8(terms_blob), len(terms_blob),
            len(hashes), doc_count,
        )

    def term_postings(self, h: int):
        """(docids u16[n], tfs u16[n, F]) of a term, docids ascending, or
        None where the accumulator lacks it."""
        fn = self.lib.st_accum_term_postings
        n = fn(self.ptr, h, None, None, 0)
        while n > 0:
            docids = np.empty(n, np.uint16)
            tfs = np.empty((n, self.n_fields), np.uint16)
            got = fn(self.ptr, h, docids.ctypes.data, tfs.ctypes.data, n)
            if got >= 0:
                return (docids[:got], tfs[:got]) if got else None
            # an ingest grew the list between the two calls
            n = fn(self.ptr, h, None, None, 0)
        return None

    def term_doc_positions(self, h: int, docid: int):
        tfs = np.zeros(self.n_fields, np.uint16)
        buf = np.zeros(65536, np.uint16)
        n = self.lib.st_accum_term_doc_positions(
            self.ptr, C.c_uint64(h), docid, _arr(tfs, C.c_uint16),
            _arr(buf, C.c_uint16), len(buf),
        )
        if n < 0:
            return None
        out = []
        off = 0
        for f in range(self.n_fields):
            out.append(buf[off : off + int(tfs[f])].astype(np.int64))
            off += int(tfs[f])
        return out
