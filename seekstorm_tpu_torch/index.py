"""Index root: schema handling, shards, level-0 RAM indexing, commit packing,
persistence, open/close, document CRUD.

The port's copy of ``seekstorm_tpu/index.py``: the same on-disk format, byte
for byte.  What differs: an index is bound to a torch device (``device=`` of
``create_index``/``open_index``, default ``"cuda"``), on which commit's
frequent-word warmup runs through the port's ``search_batch``;
``precompile`` is gone (PyTorch compiles nothing per shape); a delete during
commit's warmup leaves the warmup cache empty instead of stale (``warmup``);
``attach_mesh`` takes a list of torch devices (``parallel/mesh.Mesh``), which
may repeat a device, in place of a JAX mesh.  A vector index's commit-time
clustering runs on the index's device.

Structure mirrors the reference's lifecycle (reference seekstorm/src/index.rs
create_index :1886 / open_index :3832 / doc CRUD traits :5081-5299,
commit.rs:50-258) re-architected for the TPU data plane:

* Each shard accumulates up to 65,536 docs in a mutable RAM level 0
  (reference ROARING_BLOCK_SIZE index.rs:115, ARCHITECTURE.md:89); commit
  packs it into immutable fixed-layout numpy levels on disk and rebuilds the
  HBM-resident CSR tensors + term directory (lexindex.build_shard_lexical).
* A partial (non-64K) last level is rewritten in full at each commit while
  its docs stay RAM-resident in level 0 — the same net semantics as the
  reference's merge-incomplete-level-back-to-level0 (commit.rs:204-258)
  without array surgery.
* Realtime search scans the uncommitted level-0 tail with the numpy oracle
  and merges with device results (reference realtime_search.rs:921 analog).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import geo
from .docstore import LevelDocStore, compress_doc, decompress_doc
from .lexindex import (CommittedLevel, ShardLexical, build_shard_lexical,
                       build_shard_lexical_cached)
from .oracle import OracleTermPostings, bm25_components, term_impacts
from .schema import (
    BLOCK_SIZE,
    FACET_DTYPES,
    AccessType,
    FieldType,
    IndexMeta,
    LexicalSimilarity,
    SchemaField,
    schema_from_json,
    schema_to_json,
)
from .tokenizer import Analyzer
from .utils import (DLC_LIST, DOCUMENT_LENGTH_COMPRESSION,
                    compress_lengths, compress_lengths_bytes, term_hash)


def _committed_from_arrays(doc_count, positions_sum_normalized, hashes,
                           offsets, docid, tf, pos, doclen,
                           names) -> CommittedLevel:
    """The CommittedLevel that CommittedLevel.load would produce for the
    level pack() just wrote, built from the in-RAM arrays (no disk
    decode).  Field-for-field identical: the durable posting codec
    roundtrips bit-exactly (tests/test_postings_codec.py) and every
    other field is written verbatim."""
    per_posting = tf.sum(axis=1, dtype=np.int64)
    pos_offset = np.zeros(len(tf) + 1, dtype=np.int64)
    np.cumsum(per_posting, out=pos_offset[1:])
    return CommittedLevel(
        doc_count=doc_count,
        positions_sum_normalized=positions_sum_normalized,
        term_hash=hashes,
        term_offset=offsets,
        docid=docid,
        tf=tf,
        pos=pos,
        pos_offset=pos_offset,
        doclen=doclen,
        term_names=names,
    )


class _TermPostings0:
    """Level-0 postings for one term (append-only, docid-ascending)."""

    __slots__ = ("docids", "tfs", "poss")

    def __init__(self):
        self.docids: list[int] = []
        self.tfs: list[int] = []    # flattened: F entries per posting
        self.poss: list[int] = []   # flattened positions, field-major per posting


def _write_postings(path: Path, offsets, docid, tf, pos) -> None:
    """Durable level postings: the compact varint stream (native
    st_pack_postings — per-term delta docids, field-mask tfs, delta
    positions; ~40% the bytes of the fixed-width arrays) prefixed by an
    8-byte position count, falling back to the fixed-width .npy triple
    when the native library is unavailable.  CommittedLevel.load reads
    both forms."""
    from . import native as native_mod

    blob = native_mod.pack_postings(offsets, docid, tf, pos)
    if blob is None:
        np.save(path / "docid.npy", docid)
        np.save(path / "tf.npy", tf)
        np.save(path / "pos.npy", pos)
        return
    with open(path / "postings.bin", "wb") as f:
        f.write(np.int64(len(pos)).tobytes())
        f.write(blob)


class Level0:
    """Mutable RAM level of one shard (up to BLOCK_SIZE docs)."""

    def __init__(self, n_fields: int, facet_ids: list[int]):
        self.n_fields = n_fields
        self.doc_count = 0
        self.terms: dict[int, _TermPostings0] = {}
        self.term_str: dict[int, str] = {}
        self.doclen: list[bytes] = []          # compressed u8 per field, per doc
        self.positions_sum_normalized = 0
        self.facet_values: dict[int, list] = {fid: [] for fid in facet_ids}
        self.blobs: list[bytes] = []

    def add_document(
        self,
        term_fields: dict[str, list[list[int]]],  # term -> per-field positions
        field_lengths: list[int],
        facet_vals: dict[int, object],
        blob: bytes,
    ) -> int:
        local = self.doc_count
        F = self.n_fields
        for term, perfield in term_fields.items():
            h = term_hash(term)
            tp = self.terms.get(h)
            if tp is None:
                tp = _TermPostings0()
                self.terms[h] = tp
                self.term_str[h] = term
            tp.docids.append(local)
            for f in range(F):
                plist = perfield[f]
                tp.tfs.append(min(len(plist), 65_535))
                tp.poss.extend(p for p in plist[:65_535])
        lens = compress_lengths(np.array(field_lengths, dtype=np.int64))
        self.doclen.append(lens.tobytes())
        self.positions_sum_normalized += int(
            DOCUMENT_LENGTH_COMPRESSION[lens].sum()
        )
        for fid, vals in self.facet_values.items():
            vals.append(facet_vals.get(fid))
        self.blobs.append(blob)
        self.doc_count += 1
        return local

    # ------------------------------------------------------------------
    def pack(self, path: Path, facet_fields: list[SchemaField]):
        """Write this level as an immutable packed level directory.

        Returns the equivalent in-RAM CommittedLevel (identical to what
        CommittedLevel.load reads back — the posting codec roundtrip is
        parity-pinned by tests/test_postings_codec.py), so commit can
        seed the shard level cache and skip re-decoding the level it
        just wrote: at 5M docs the decode of all fresh levels was ~70%
        of commit wall."""
        path.mkdir(parents=True, exist_ok=True)
        F = self.n_fields
        hashes = np.array(sorted(self.terms.keys()), dtype=np.uint64)
        T = len(hashes)
        counts = np.zeros(T, dtype=np.int64)
        for i, h in enumerate(hashes):
            counts[i] = len(self.terms[int(h)].docids)
        offsets = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        P = int(offsets[-1])
        docid = np.zeros(P, dtype=np.uint16)
        tf = np.zeros((P, F), dtype=np.uint16)
        pos_chunks: list[list[int]] = []
        for i, h in enumerate(hashes):
            tp = self.terms[int(h)]
            a = int(offsets[i])
            n = len(tp.docids)
            docid[a : a + n] = tp.docids
            tf[a : a + n] = np.asarray(tp.tfs, dtype=np.uint16).reshape(n, F)
            pos_chunks.append(tp.poss)
        pos = (
            np.concatenate([np.asarray(c, dtype=np.uint16) for c in pos_chunks])
            if pos_chunks
            else np.zeros(0, np.uint16)
        )
        doclen = (
            np.frombuffer(b"".join(self.doclen), dtype=np.uint8).reshape(
                self.doc_count, F
            )
            if self.doc_count
            else np.zeros((0, F), np.uint8)
        )
        np.save(path / "term_hash.npy", hashes)
        np.save(path / "term_offset.npy", offsets)
        _write_postings(path, offsets, docid, tf, pos)
        np.save(path / "doclen.npy", doclen)
        with open(path / "terms.txt", "wb") as f:
            f.write(
                b"".join(
                    self.term_str.get(int(h), "").encode() + b"\n"
                    for h in hashes
                )
            )
        for sf in facet_fields:
            col = facet_column(sf, self.facet_values[sf.facet_id], self.doc_count)
            np.save(path / f"facet_{sf.facet_id}.npy", col)
        LevelDocStore.write(path, self.blobs)
        with open(path / "level.json", "w") as f:
            json.dump(
                {
                    "doc_count": self.doc_count,
                    "positions_sum_normalized": self.positions_sum_normalized,
                },
                f,
            )
        names = [self.term_str.get(int(h), "") for h in hashes]
        return _committed_from_arrays(
            self.doc_count, self.positions_sum_normalized, hashes, offsets,
            docid, tf, pos, doclen, names)

    @staticmethod
    def from_level(
        lvl: CommittedLevel, path: Path, facet_ids: list[int], n_fields: int
    ) -> "Level0":
        """Reload a partial committed level back into RAM (open_index path)."""
        l0 = Level0(n_fields, facet_ids)
        l0.doc_count = lvl.doc_count
        l0.positions_sum_normalized = lvl.positions_sum_normalized
        l0.doclen = [np.asarray(lvl.doclen[i]).tobytes() for i in range(lvl.doc_count)]
        if lvl.term_names:
            l0.term_str = {
                int(h): nm for h, nm in zip(lvl.term_hash, lvl.term_names)
            }
        for t in range(len(lvl.term_hash)):
            h = int(lvl.term_hash[t])
            tp = _TermPostings0()
            a, b = int(lvl.term_offset[t]), int(lvl.term_offset[t + 1])
            tp.docids = lvl.docid[a:b].tolist()
            tp.tfs = np.asarray(lvl.tf[a:b]).reshape(-1).tolist()
            tp.poss = lvl.pos[lvl.pos_offset[a] : lvl.pos_offset[b]].tolist()
            l0.terms[h] = tp
        # raw blobs + facet values
        ptr = np.load(path / "docptr.npy")
        data = np.fromfile(path / "docs.bin", dtype=np.uint8)
        l0.blobs = [
            bytes(data[int(ptr[i]) : int(ptr[i + 1])]) for i in range(lvl.doc_count)
        ]
        for fid in facet_ids:
            fp = path / f"facet_{fid}.npy"
            if fp.exists():
                l0.facet_values[fid] = np.load(fp).tolist()
        return l0


class NativeLevel0(Level0):
    """Level 0 backed by the C++ accumulator (native/seekstorm_native.cpp):
    tokenization, posting/position accumulation, n-grams, synonyms and
    dictionary/completion counting run natively; doc-store blobs, facet
    values and doc lengths stay on the Python side."""

    def __init__(self, n_fields: int, facet_ids: list[int]):
        super().__init__(n_fields, facet_ids)
        from .native import NativeAccumulator

        self.acc = NativeAccumulator(n_fields)
        self._term_str_cache = None

    def add_document_native(
        self, cfg, field_texts: list[bytes], facet_vals, blob: bytes
    ) -> int:
        local, lens = self.acc.add_doc(cfg, field_texts)
        clens = compress_lengths_bytes(lens)
        self.doclen.append(clens)
        self.positions_sum_normalized += sum(DLC_LIST[c] for c in clens)
        self._after_add(facet_vals, blob)
        return local

    def add_documents_native(
        self, cfg, texts_flat: list[bytes], facet_vals_list: list,
        blobs: list[bytes],
    ) -> int:
        """Batch path: ONE C call for the whole chunk (bulk-ingest hot path;
        per-call ctypes marshalling dominated single-core throughput)."""
        first, lens = self.acc.add_docs(cfg, texts_flat)
        F = self.n_fields
        for i in range(len(blobs)):
            clens = compress_lengths_bytes(lens[i * F : (i + 1) * F])
            self.doclen.append(clens)
            self.positions_sum_normalized += sum(DLC_LIST[c] for c in clens)
        for fid, vals in self.facet_values.items():
            vals.extend(fv.get(fid) for fv in facet_vals_list)
        self.blobs.extend(blobs)
        self.doc_count += len(blobs)
        self._term_str_cache = None
        return first

    def _after_add(self, facet_vals, blob) -> None:
        for fid, vals in self.facet_values.items():
            vals.append(facet_vals.get(fid))
        self.blobs.append(blob)
        self.doc_count += 1
        self._term_str_cache = None

    @property
    def term_str(self) -> dict:
        if self._term_str_cache is None:
            blob = self.acc.terms_blob()
            names = blob.decode().split("\n")[:-1] if blob else []
            h, _, _, _, _ = self.acc.pack()
            self._term_str_cache = {int(hh): nm for hh, nm in zip(h, names)}
        return self._term_str_cache

    @term_str.setter
    def term_str(self, v):  # base-class __init__ assigns {}
        self._term_str_cache = None

    def pack(self, path: Path, facet_fields: list[SchemaField]):
        path.mkdir(parents=True, exist_ok=True)
        F = self.n_fields
        hashes, offsets, docid, tf, pos = self.acc.pack()
        np.save(path / "term_hash.npy", hashes)
        np.save(path / "term_offset.npy", offsets)
        _write_postings(path, offsets, docid, tf, pos)
        doclen = (
            np.frombuffer(b"".join(self.doclen), dtype=np.uint8).reshape(
                self.doc_count, F
            )
            if self.doc_count
            else np.zeros((0, F), np.uint8)
        )
        np.save(path / "doclen.npy", doclen)
        blob = self.acc.terms_blob()
        with open(path / "terms.txt", "wb") as f:
            f.write(blob)
        for sf in facet_fields:
            col = facet_column(sf, self.facet_values[sf.facet_id], self.doc_count)
            np.save(path / f"facet_{sf.facet_id}.npy", col)
        LevelDocStore.write(path, self.blobs)
        with open(path / "level.json", "w") as f:
            json.dump(
                {
                    "doc_count": self.doc_count,
                    "positions_sum_normalized": self.positions_sum_normalized,
                },
                f,
            )
        names = blob.decode().split("\n")[:-1] if blob else []
        return _committed_from_arrays(
            self.doc_count, self.positions_sum_normalized, hashes, offsets,
            docid, tf, pos, doclen, names)

    @staticmethod
    def from_level(
        lvl: CommittedLevel, path: Path, facet_ids: list[int], n_fields: int
    ) -> "NativeLevel0":
        l0 = NativeLevel0(n_fields, facet_ids)
        l0.doc_count = lvl.doc_count
        l0.positions_sum_normalized = lvl.positions_sum_normalized
        l0.doclen = [
            np.asarray(lvl.doclen[i]).tobytes() for i in range(lvl.doc_count)
        ]
        tpath = path / "terms.txt"
        if tpath.exists():
            blob = tpath.read_bytes()
        else:
            blob = b"\n" * len(lvl.term_hash)
        l0.acc.load_packed(
            np.asarray(lvl.term_hash), np.asarray(lvl.term_offset),
            np.asarray(lvl.docid), np.asarray(lvl.tf), np.asarray(lvl.pos),
            blob, lvl.doc_count,
        )
        ptr = np.load(path / "docptr.npy")
        data = np.fromfile(path / "docs.bin", dtype=np.uint8)
        l0.blobs = [
            bytes(data[int(ptr[i]) : int(ptr[i + 1])])
            for i in range(lvl.doc_count)
        ]
        for fid in facet_ids:
            fp = path / f"facet_{fid}.npy"
            if fp.exists():
                l0.facet_values[fid] = np.load(fp).tolist()
        return l0


def facet_column(sf: SchemaField, values: list, n: int) -> np.ndarray:
    """Build a fixed-width facet column from per-doc values."""
    dtype = FACET_DTYPES[sf.field_type]
    if sf.field_type == FieldType.Point:
        lat = np.array([v[0] if v else 0.0 for v in values], dtype=np.float64)
        lon = np.array([v[1] if v else 0.0 for v in values], dtype=np.float64)
        return geo.encode_morton_2_d(lat, lon)
    col = np.zeros(n, dtype=dtype)
    for i, v in enumerate(values):
        if v is not None:
            col[i] = v
    return col


@dataclass
class Shard:
    """One shard: committed levels (disk + HBM) + RAM level 0."""

    shard_id: int
    path: Path
    n_fields: int
    facet_ids: list[int]
    level0: Level0 = None  # type: ignore
    full_levels: int = 0           # number of complete 64K levels on disk
    partial_on_disk: int = 0       # docs of level0 already persisted as last level
    # per-shard ingest lock: shard-parallel indexing serializes only within
    # a shard (reference index.rs shard parallelism analog)
    ingest_lock: threading.Lock = field(default_factory=threading.Lock)
    lexical: ShardLexical = None   # type: ignore
    docstores: list[LevelDocStore] = field(default_factory=list)
    deleted: set = field(default_factory=set)  # shard-local doc ids
    facet_cols: dict[int, np.ndarray] = field(default_factory=dict)  # concat over levels

    @property
    def committed_doc_count(self) -> int:
        return self.full_levels * BLOCK_SIZE + self.partial_on_disk

    @property
    def doc_count(self) -> int:
        return self.full_levels * BLOCK_SIZE + self.level0.doc_count

    @property
    def tail_start(self) -> int:
        """First shard-local doc id served by the realtime (uncommitted) path."""
        return self.committed_doc_count

    def tail_len(self) -> int:
        return self.level0.doc_count - self.partial_on_disk


class Index:
    """The index root (reference Index index.rs:1698)."""

    def __init__(
        self,
        path: Path,
        schema: list[SchemaField],
        meta: IndexMeta,
        shard_count: int,
        serialize: bool = True,
        device="cuda",
    ):
        from .search import resolve_device

        self.device = resolve_device(device)
        self.path = Path(path)
        self.meta = meta
        self.schema = schema
        self.shard_count = shard_count
        self.docid_global = 0
        self._lock = threading.RLock()

        # assign ids
        self.schema_map = {}
        self.indexed_fields: list[SchemaField] = []
        self.facet_fields: list[SchemaField] = []
        fid = 0
        for sf in schema:
            sf.field_id = fid
            fid += 1
            if sf.indexed and sf.field_type in (FieldType.Text, FieldType.String16,
                                                FieldType.String32):
                sf.indexed_field_id = len(self.indexed_fields)
                self.indexed_fields.append(sf)
            if sf.facet:
                sf.facet_id = len(self.facet_fields)
                self.facet_fields.append(sf)
            self.schema_map[sf.field] = sf
        if not self.indexed_fields:
            # allow pure-vector / facet-only indices; keep one dummy slot
            pass

        self.analyzer = Analyzer(
            meta.tokenizer, meta.stemmer, meta.stop_words, meta.custom_stop_words
        )
        self.boosts = np.array(
            [sf.boost for sf in self.indexed_fields], dtype=np.float32
        )
        self.synonyms: list[dict] = []
        self._synonym_map: dict[str, set] = {}

        # spelling dictionary + query completions (reference commit.rs:418-443)
        from .rewrite import PruningRadixTrie, SymSpell

        sc = meta.spelling_correction
        self.spell = (
            SymSpell(
                max_edit=sc.max_dictionary_edit_distance,
                count_threshold=sc.count_threshold,
                max_entries=sc.max_dictionary_entries,
            )
            if sc.enabled
            else None
        )
        qc = meta.query_completion
        self.completions = (
            PruningRadixTrie(max_entries=qc.max_completion_entries)
            if qc.enabled
            else None
        )
        self._dict_field_ids = [
            sf.indexed_field_id for sf in self.indexed_fields
            if sf.dictionary_source
        ] or [sf.indexed_field_id for sf in self.indexed_fields]
        self._completion_fields = [
            sf.field for sf in schema if sf.completion_source
        ] or [sf.field for sf in self.indexed_fields]

        from .ngram import frequent_word_set

        self._frequent_words = frequent_word_set(meta)

        # native (C++) ingest path when the shared library is available
        from . import native as native_mod

        from .schema import TokenizerType as _TT

        # The C++ tokenizer implements None/English(Porter) stemming plus
        # the native Snowball ports (snowball.cpp; native._STEMMER_IDS) —
        # remaining stemmer languages (stemmers.py light tier) take the
        # Python ingest path.
        # ZH dictionary segmentation IS ported to C++ (zh_segment in
        # seekstorm_native.cpp, the same DP as word_segmentation.py); ZH
        # falls back to Python only when no dictionary file resolves (the
        # Python seed lexicon differs from the C++ char-level fallback).
        zh_ok = True
        if meta.tokenizer == _TT.UnicodeAlphanumericZH:
            from .word_segmentation import resolve_dict_path

            zh_ok = resolve_dict_path() is not None
        self._native = (
            native_mod.available()
            and zh_ok
            and native_mod.stemmer_supported(meta.stemmer.value)
        )
        self._native_cfg = None
        self._facet_tab_lock = threading.Lock()
        # orders a delete's reset of the warmup cache against a commit's
        # install of it (see warmup)
        self._warm_lock = threading.Lock()
        # Bm25f scores n-gram postings with per-constituent tfs/idfs
        # (reference add_result.rs:868-915); Bm25fProximity scores the
        # n-gram as a single term with its own idf (add_result.rs:917-919)
        self._expand_ngrams = (
            self.meta.similarity == LexicalSimilarity.Bm25f
            and bool(self.meta.ngram_indexing)
        )

        self.shards: list[Shard] = []
        facet_ids = [sf.facet_id for sf in self.facet_fields]
        for s in range(shard_count):
            sp = self.path / f"shard_{s}"
            sh = Shard(s, sp, max(len(self.indexed_fields), 1), facet_ids)
            sh.level0 = self._new_level0()
            sh.lexical = build_shard_lexical([], self.boosts_or_default())
            self.shards.append(sh)

        # vector engine attached lazily (vector_index.ShardVectors)
        self.vectors = None

        if serialize:
            self.path.mkdir(parents=True, exist_ok=True)
            for sh in self.shards:
                sh.path.mkdir(parents=True, exist_ok=True)
            self.save_meta()

    # ------------------------------------------------------------------
    def _new_level0(self):
        facet_ids = [f.facet_id for f in self.facet_fields]
        n_fields = max(len(self.indexed_fields), 1)
        if self._native:
            return NativeLevel0(n_fields, facet_ids)
        return Level0(n_fields, facet_ids)

    def _get_native_cfg(self):
        if self._native_cfg is None:
            from .native import NativeConfig

            self._native_cfg = NativeConfig(self)
        return self._native_cfg

    # ------------------------------------------------------------------
    def boosts_or_default(self) -> np.ndarray:
        if len(self.boosts):
            return self.boosts
        return np.ones(1, dtype=np.float32)

    def save_meta(self) -> None:
        with open(self.path / "index.json", "w") as f:
            json.dump(
                {
                    "meta": self.meta.to_json(),
                    "shard_count": self.shard_count,
                    "docid_global": self.docid_global,
                },
                f,
                indent=1,
            )
        with open(self.path / "schema.json", "w") as f:
            f.write(schema_to_json(self.schema))
        with open(self.path / "synonyms.json", "w") as f:
            json.dump(self.synonyms, f)

    # ------------------------------------------------------------------
    # document CRUD (reference index.rs:5081-5299)

    def index_document(self, doc: dict) -> int:
        """Thread-safe single-document ingest.

        The shard is chosen round-robin, but the returned global id is
        derived from the shard slot actually taken under the shard's ingest
        lock — concurrent callers can interleave appends within a shard
        without breaking the `local == global_id // shard_count` invariant
        that get_document/delete_document rely on (reference doc-id
        globalization, index.rs:5284-5290)."""
        from .metrics import METRICS

        METRICS.inc("docs_indexed_total")
        with self._lock:
            rr = self.docid_global
            self.docid_global += 1
        shard = self.shards[rr % self.shard_count]
        return self._index_document_shard(shard, doc)

    def index_documents(self, docs: list[dict]) -> list[int]:
        """Batch ingest; shard-parallel on the native path (reference
        README.md:88 '35K docs/sec sharded' — indexing parallelism is
        per-shard, one worker thread per shard, C ABI calls release the
        GIL so tokenization/accumulation run concurrently)."""
        native_all = self._native and all(
            isinstance(sh.level0, NativeLevel0) for sh in self.shards
        )
        if not native_all or len(docs) < 64:
            return [self.index_document(d) for d in docs]
        from .metrics import METRICS

        METRICS.inc("docs_indexed_total", len(docs))
        self._get_native_cfg()  # build once before fan-out
        with self._lock:
            g0 = self.docid_global
            self.docid_global += len(docs)
        per_shard: list[list[tuple[int, dict]]] = [
            [] for _ in range(self.shard_count)
        ]
        for i, d in enumerate(docs):
            per_shard[(g0 + i) % self.shard_count].append((i, d))
        ids = [0] * len(docs)

        import concurrent.futures as cf

        def worker(si: int) -> None:
            sh = self.shards[si]
            ds = per_shard[si]
            cfg = self._get_native_cfg()
            i = 0
            while i < len(ds):
                # split batches at level (64K-doc) boundaries
                room = max(BLOCK_SIZE - sh.level0.doc_count, 1)
                chunk = ds[i : i + room]
                texts: list[bytes] = []
                fvals, blobs = [], []
                for _, d in chunk:
                    texts.extend(self._native_field_texts(d))
                    fvals.append(self._doc_facet_vals(d))
                    blobs.append(self._doc_blob(d))
                with sh.ingest_lock:
                    base = sh.full_levels * BLOCK_SIZE
                    first = sh.level0.add_documents_native(
                        cfg, texts, fvals, blobs
                    )
                    # global ids from the slots actually taken (safe under
                    # concurrent per-shard interleaving)
                    for j, (oi, d) in enumerate(chunk):
                        ids[oi] = (base + first + j) * self.shard_count + si
                        if self.vectors is not None:
                            self.vectors.ingest(sh.shard_id, first + j, d)
                    if sh.level0.doc_count >= BLOCK_SIZE:
                        with self._lock:
                            self._commit_shard(sh, reload=False)
                i += len(chunk)

        workers = min(self.shard_count, os.cpu_count() or 8)
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(worker, range(self.shard_count)))
        return ids

    def _native_field_texts(self, doc: dict) -> list[bytes]:
        field_texts = []
        for sf in self.indexed_fields:
            text = doc.get(sf.field)
            if text is None:
                text = ""
            elif not isinstance(text, str):
                text = json.dumps(text, ensure_ascii=False)
            field_texts.append(text.encode())
        return field_texts or [b""]

    def _doc_facet_vals(self, doc: dict) -> dict:
        facet_vals: dict[int, object] = {}
        for sf in self.facet_fields:
            v = doc.get(sf.field)
            if v is not None and sf.field_type.is_string_facet:
                v = self._facet_ordinal(sf, v)
            facet_vals[sf.facet_id] = v
        return facet_vals

    def _doc_blob(self, doc: dict) -> bytes:
        stored = {
            sf.field: doc[sf.field]
            for sf in self.schema
            if sf.stored and sf.field in doc
        }
        return compress_doc(stored, self.meta.doc_compression)

    def _index_document_shard_native(self, shard: Shard, doc: dict) -> int:
        """C++ fast path: tokenize + accumulate postings natively."""
        field_texts = self._native_field_texts(doc)
        facet_vals = self._doc_facet_vals(doc)
        blob = self._doc_blob(doc)

        with shard.ingest_lock:
            base = shard.full_levels * BLOCK_SIZE
            local = shard.level0.add_document_native(
                self._get_native_cfg(), field_texts, facet_vals, blob
            )
            gid = (base + local) * self.shard_count + shard.shard_id
            if self.vectors is not None:
                self.vectors.ingest(shard.shard_id, local, doc)
            if shard.level0.doc_count >= BLOCK_SIZE:
                # bulk-ingest fast path: pack the full level but defer the
                # O(levels) directory/HBM rebuild until the next search or
                # explicit commit. Commit mutates shared index state ->
                # global lock (nested inside the shard lock; the global
                # lock is RLock and commit never takes other shard locks)
                with self._lock:
                    self._commit_shard(shard, reload=False)
        return gid

    def _index_document_shard(self, shard: Shard, doc: dict) -> int:
        if self._native and isinstance(shard.level0, NativeLevel0):
            return self._index_document_shard_native(shard, doc)
        term_fields: dict[str, list[list[int]]] = {}
        F = max(len(self.indexed_fields), 1)
        field_lengths = [0] * F
        tokens_per_field: dict[int, list[str]] = {}
        for sf in self.indexed_fields:
            text = doc.get(sf.field)
            if text is None:
                continue
            if not isinstance(text, str):
                text = json.dumps(text, ensure_ascii=False)
            toks = self.analyzer.analyze(text)[:65_535]
            tokens_per_field[sf.indexed_field_id] = toks
            field_lengths[sf.indexed_field_id] = len(toks)
            for pos, tok in enumerate(toks):
                pf = term_fields.get(tok)
                if pf is None:
                    pf = [[] for _ in range(F)]
                    term_fields[tok] = pf
                pf[sf.indexed_field_id].append(pos)

        facet_vals: dict[int, object] = {}
        for sf in self.facet_fields:
            v = doc.get(sf.field)
            if v is not None and sf.field_type.is_string_facet:
                v = self._facet_ordinal(sf, v)
            facet_vals[sf.facet_id] = v

        # feed the spelling dictionary (terms sampled by hash, reference
        # index_posting.rs:25-49) and the completion trie (token 1..3-grams
        # of completion_source fields, reference commit.rs:418-425)
        if self.spell is not None:
            for term, pf in term_fields.items():
                cnt = sum(len(pf[f]) for f in self._dict_field_ids)
                if cnt and (term_hash(term) & 7) == 0:
                    self.spell.add(term, cnt)
        if self.completions is not None:
            comp_ids = {
                sf.indexed_field_id for sf in self.indexed_fields
                if sf.field in self._completion_fields
            }
            for fid2, toks in tokens_per_field.items():
                if fid2 not in comp_ids:
                    continue
                for n in (1, 2, 3):
                    for i in range(len(toks) - n + 1):
                        self.completions.add(" ".join(toks[i : i + n]))

        # n-gram indexing of frequent-term runs (reference NGRAM_SEARCH.md,
        # tokenizer.rs:664-830); composite terms join the same posting space
        if self.meta.ngram_indexing and self._frequent_words:
            from .ngram import generate_ngrams

            for fid2, toks in tokens_per_field.items():
                for gterm, positions in generate_ngrams(
                    toks, self._frequent_words, self.meta.ngram_indexing
                ).items():
                    pf = term_fields.get(gterm)
                    if pf is None:
                        pf = [[] for _ in range(F)]
                        term_fields[gterm] = pf
                    pf[fid2].extend(positions)

        # index-time synonym expansion (reference index.rs:1077-1090,
        # get_synonyms_map :1782 — documents are additionally indexed under
        # their terms' synonyms; one-way maps later terms to the first only)
        if self._synonym_map:
            extra: dict[str, list[list[int]]] = {}
            for term, pf in term_fields.items():
                for syn in self._synonym_map.get(term, ()):
                    tgt = extra.setdefault(
                        syn, [[] for _ in range(len(pf))]
                    )
                    for f, plist in enumerate(pf):
                        tgt[f] = sorted(set(tgt[f]) | set(plist))
            for syn, pf in extra.items():
                if syn in term_fields:
                    for f in range(len(pf)):
                        term_fields[syn][f] = sorted(
                            set(term_fields[syn][f]) | set(pf[f])
                        )
                else:
                    term_fields[syn] = pf

        stored = {
            sf.field: doc[sf.field]
            for sf in self.schema
            if sf.stored and sf.field in doc
        }
        blob = compress_doc(stored, self.meta.doc_compression)

        with self._lock:
            base = shard.full_levels * BLOCK_SIZE
            local = shard.level0.add_document(
                term_fields, field_lengths, facet_vals, blob
            )
            gid = (base + local) * self.shard_count + shard.shard_id
            if self.vectors is not None:
                self.vectors.ingest(shard.shard_id, local, doc)
            if shard.level0.doc_count >= BLOCK_SIZE:
                self._commit_shard(shard, reload=False)
        return gid

    # string facet ordinals (per facet field string table)
    def _facet_ordinal(self, sf: SchemaField, value) -> int:
        # leaf lock: string-table mutation must be atomic under
        # shard-parallel ingest (never held while taking another lock)
        lk = getattr(self, "_facet_tab_lock", None)
        if lk is None:
            lk = self._facet_tab_lock = threading.Lock()
        with lk:
            return self._facet_ordinal_locked(sf, value)

    def _facet_ordinal_locked(self, sf: SchemaField, value) -> int:
        tables = getattr(self, "_facet_tables", None)
        if tables is None:
            tables = self._facet_tables = {}
        tab = tables.setdefault(sf.facet_id, {"": 0})
        if sf.field_type in (FieldType.StringSet16, FieldType.StringSet32):
            # string SETS: the column stores an ordinal per distinct value
            # combination (reference string_set_to_single_term_id); counting
            # expands set ordinals to per-value counts at assembly
            if not isinstance(value, (list, tuple, set)):
                value = [value]
            members = []
            for v in value:
                v = str(v)
                if v not in tab:
                    tab[v] = len(tab)
                members.append(tab[v])
            key = tuple(sorted(set(members)))
            sets = getattr(self, "_facet_set_tables", None)
            if sets is None:
                sets = self._facet_set_tables = {}
            stab = sets.setdefault(sf.facet_id, {(): 0})
            if key not in stab:
                stab[key] = len(stab)
            return stab[key]
        if isinstance(value, list):
            value = value[0] if value else ""
        v = str(value)
        if v not in tab:
            tab[v] = len(tab)
        return tab[v]

    def facet_string_for(self, sf: SchemaField, ordinal: int) -> str:
        tab = getattr(self, "_facet_tables", {}).get(sf.facet_id, {"": 0})
        rev = {v: k for k, v in tab.items()}
        return rev.get(int(ordinal), "")

    def get_document(self, global_id: int) -> dict | None:
        shard = self.shards[global_id % self.shard_count]
        if getattr(shard, "_needs_reload", False):
            # deferred-reload bulk ingest leaves docstores stale until the
            # next ensure_loaded (search_batch does this; doc fetch must too)
            self.ensure_loaded()
        local = global_id // self.shard_count
        if local >= shard.doc_count:
            return None
        lvl, lid = divmod(local, BLOCK_SIZE)
        if lvl < shard.full_levels:
            return shard.docstores[lvl].get(lid)
        blob = shard.level0.blobs[lid]
        return decompress_doc(blob, self.meta.doc_compression)

    def delete_document(self, global_id: int) -> None:
        shard = self.shards[global_id % self.shard_count]
        local = global_id // self.shard_count
        if local < shard.doc_count:
            shard.deleted.add(local)
            shard._dev = None
            with self._warm_lock:
                self._warmup_cache = {}
            self._save_deletes(shard)

    def delete_documents(self, ids: list[int]) -> None:
        touched = set()
        for g in ids:
            shard = self.shards[g % self.shard_count]
            local = g // self.shard_count
            if local < shard.doc_count:
                shard.deleted.add(local)
                touched.add(shard.shard_id)
        if touched:
            with self._warm_lock:
                self._warmup_cache = {}
            for sid in touched:
                self.shards[sid]._dev = None
                self._save_deletes(self.shards[sid])

    def update_document(self, global_id: int, doc: dict) -> int:
        """Delete + reindex (new doc id), reference UpdateDocument semantics."""
        self.delete_document(global_id)
        return self.index_document(doc)

    def update_documents(self, pairs: list[tuple[int, dict]]) -> list[int]:
        return [self.update_document(g, d) for g, d in pairs]

    def _save_deletes(self, shard: Shard) -> None:
        arr = np.array(sorted(shard.deleted), dtype=np.int64)
        np.save(shard.path / "deleted.npy", arr)

    @property
    def indexed_doc_count(self) -> int:
        return sum(sh.doc_count for sh in self.shards)

    @property
    def committed_doc_count(self) -> int:
        return sum(sh.committed_doc_count for sh in self.shards)

    @property
    def deleted_doc_count(self) -> int:
        return sum(len(sh.deleted) for sh in self.shards)

    @property
    def current_doc_count(self) -> int:
        return self.indexed_doc_count - self.deleted_doc_count

    # ------------------------------------------------------------------
    # commit (reference commit.rs:50-258)

    def ensure_loaded(self) -> None:
        """Apply any deferred level reloads (bulk-ingest fast path)."""
        with self._lock:
            for sh in self.shards:
                if getattr(sh, "_needs_reload", False):
                    self._reload_shard(sh)

    def commit(self) -> None:
        """Commit all shards (reference Commit commit.rs:50-166 — parallel
        per-shard JoinSet).  The level pack runs sequentially under the
        locks (it feeds shared spelling/completion state); the expensive
        phase — rebuilding each shard's committed structures + device
        inputs (build_shard_lexical) — runs shard-parallel, so commit
        wall-time scales with the largest shard, not the sum."""
        # lock order everywhere: shard.ingest_lock BEFORE self._lock
        # (parallel-ingest workers hold a shard lock when a full level
        # triggers a nested commit under the global lock)
        for sh in self.shards:
            with sh.ingest_lock, self._lock:
                self._commit_shard(sh, reload=False)
        need = [sh for sh in self.shards
                if getattr(sh, "_needs_reload", False)]
        if len(need) > 1:
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(
                max_workers=min(len(need), os.cpu_count() or 8)
            ) as ex:
                list(ex.map(self._reload_shard, need))
        else:
            for sh in need:
                self._reload_shard(sh)
        with self._lock:
            self.save_meta()
            if self._frequent_words:
                self.warmup()
            _save_facet_tables(self)
            if self.spell is not None:
                self.spell.save(self.path / "dictionary.csv")
            if self.completions is not None:
                self.completions.save(self.path / "completions.csv")

    def _commit_shard(self, shard: Shard, reload: bool = True) -> None:
        from .metrics import METRICS

        METRICS.inc("commits_total")
        l0 = shard.level0
        if l0.doc_count == 0:
            if reload and getattr(shard, "_needs_reload", False):
                self._reload_shard(shard)
            return
        lvl_id = shard.full_levels
        lvl_path = shard.path / f"level_{lvl_id}"
        if lvl_path.exists():
            shutil.rmtree(lvl_path)
        packed_lvl = l0.pack(lvl_path, self.facet_fields)
        if isinstance(l0, NativeLevel0) and (
            self.spell is not None or self.completions is not None
        ):
            d, c = l0.acc.drain_counts()
            if self.spell is not None:
                for t, cnt in d.items():
                    self.spell.add(t, cnt)
            if self.completions is not None:
                for t, cnt in c.items():
                    self.completions.add(t, cnt)
        if self.vectors is not None:
            self.vectors.pack_shard_level(shard, lvl_path, lvl_id)
        if l0.doc_count >= BLOCK_SIZE:
            shard.full_levels += 1
            shard.partial_on_disk = 0
            shard.level0 = self._new_level0()
            if self.vectors is not None:
                self.vectors.on_level_complete(shard)
            # seed the immutable-level cache with the level just packed
            # (now id < full_levels, so _reload_shard can reuse it and
            # skip the disk decode it would otherwise pay)
            cache = getattr(shard, "_level_cache", None)
            if cache is None:
                cache = shard._level_cache = {}
            cache[lvl_id] = packed_lvl
        else:
            shard.partial_on_disk = l0.doc_count
        with open(shard.path / "shard.json", "w") as f:
            json.dump(
                {
                    "full_levels": shard.full_levels,
                    "partial_on_disk": shard.partial_on_disk,
                },
                f,
            )
        if reload:
            self._reload_shard(shard)
        else:
            shard._needs_reload = True

    def _reload_shard(self, shard: Shard) -> None:
        """Rebuild committed structures (host + device inputs) from disk."""
        mmap = self.meta.access_type == AccessType.Mmap
        n_levels = shard.full_levels + (1 if shard.partial_on_disk else 0)
        # Immutable-level cache: a level with id < full_levels is never
        # rewritten (commit only ever packs level_{full_levels}; reference
        # append-only levels, commit.rs:204-258), so its decoded arrays
        # are reused across commits — re-decoding every level from disk
        # was ~70% of commit wall at 5M docs.  The partial level
        # (id == full_levels) is rewritten by every commit and is never
        # cached until it fills.
        cache = getattr(shard, "_level_cache", None)
        if cache is None:
            cache = shard._level_cache = {}
        for k in [k for k in cache if k >= shard.full_levels]:
            del cache[k]
        levels = []
        for i in range(n_levels):
            lvl = cache.get(i) if i < shard.full_levels else None
            if lvl is None:
                lvl = CommittedLevel.load(shard.path / f"level_{i}",
                                          mmap=mmap)
                if i < shard.full_levels:
                    cache[i] = lvl
            levels.append(lvl)
        shard.lexical = build_shard_lexical_cached(
            shard.path, levels, self.boosts_or_default(),
            expand_ngrams=self._expand_ngrams,
        )
        shard.docstores = [
            LevelDocStore(shard.path / f"level_{i}", self.meta.doc_compression, mmap)
            for i in range(n_levels)
        ]
        shard._dev = None
        # concatenated facet columns over committed docs
        shard.facet_cols = {}
        for sf in self.facet_fields:
            cols = []
            for i in range(n_levels):
                fp = shard.path / f"level_{i}" / f"facet_{sf.facet_id}.npy"
                if fp.exists():
                    cols.append(np.load(fp, mmap_mode="r" if mmap else None))
            if cols:
                shard.facet_cols[sf.facet_id] = np.concatenate(cols)
        shard._needs_reload = False
        if self.vectors is not None:
            self.vectors.reload_shard(shard)

    # ------------------------------------------------------------------
    # realtime (level-0 tail) oracle postings

    def tail_postings(
        self, shard: Shard, hashes: list, boosts: np.ndarray
    ) -> tuple[list[OracleTermPostings | None], list[int], int]:
        """Oracle postings over the uncommitted tail of a shard.

        `hashes` entries are term hashes, or `(hash, tf_hash)` pairs for
        n-gram constituent scoring (Bm25f): docids come from the n-gram's
        postings, tfs from the constituent's postings at those docs, and
        the reported df is the CONSTITUENT's tail df (it drives idf).

        Returns (postings with docids relative to tail start, tail dfs,
        tail doc count)."""
        l0 = shard.level0
        start = shard.partial_on_disk
        n_tail = l0.doc_count - start
        end = start + n_tail
        F = shard.n_fields
        avg = self._avg_len(shard)
        out: list[OracleTermPostings | None] = []
        dfs: list[int] = []
        native = isinstance(l0, NativeLevel0)

        def lookup(h):
            """(docids i64[], tfs u16[,F]) of a term in level 0, or None."""
            if native:
                hit = l0.acc.term_postings(h)
                if hit is None:
                    return None
                return hit[0].astype(np.int64), hit[1]
            tp = l0.terms.get(h)
            if tp is None:
                return None
            return (
                np.asarray(tp.docids, dtype=np.int64),
                np.asarray(tp.tfs, dtype=np.uint16).reshape(-1, F),
            )

        for entry in hashes:
            h, tf_hash = entry if isinstance(entry, tuple) else (entry, None)
            hit = lookup(h)
            if hit is None:
                out.append(None)
                dfs.append(0)
                continue
            docids, tf = hit
            if tf_hash is not None:
                chit = lookup(tf_hash)
                if chit is not None:
                    cd, ctf = chit
                    pos = np.minimum(
                        np.searchsorted(cd, docids), len(cd) - 1
                    )
                    found = cd[pos] == docids
                    tf = np.where(found[:, None], ctf[pos], tf)
                    dfs.append(int(np.sum((cd >= start) & (cd < end))))
                else:
                    dfs.append(int(np.sum((docids >= start)
                                          & (docids < end))))
            else:
                dfs.append(int(np.sum((docids >= start) & (docids < end))))
            # bound by the entry-time doc-count snapshot: a concurrent
            # ingest can land postings (in the C++ accumulator) for a doc
            # whose Python-side doclen append hasn't happened yet — reading
            # past `end` raced exactly that window (caught by
            # test_threaded_ingest_realtime_search_stress)
            sel = (docids >= start) & (docids < end)
            if not sel.any():
                out.append(None)
                continue
            tf = tf[sel]
            dl = np.frombuffer(
                b"".join(l0.doclen[i] for i in docids[sel]), dtype=np.uint8
            ).reshape(-1, F)
            comps = bm25_components(dl, avg)
            imps = term_impacts(tf, comps, boosts)
            out.append(
                OracleTermPostings(docids=docids[sel] - start, impacts=imps,
                                   positions=None)
            )
        return out, dfs, n_tail

    def tail_positions(
        self, shard: Shard, h: int, tail_docid: int
    ) -> list[np.ndarray] | None:
        l0 = shard.level0
        if isinstance(l0, NativeLevel0):
            return l0.acc.term_doc_positions(
                h, shard.partial_on_disk + tail_docid
            )
        tp = l0.terms.get(h)
        if tp is None:
            return None
        target = shard.partial_on_disk + tail_docid
        try:
            i = tp.docids.index(target)
        except ValueError:
            return None
        F = shard.n_fields
        tf = tp.tfs[i * F : (i + 1) * F]
        start = sum(tp.tfs[: i * F])
        out = []
        for f in range(F):
            out.append(np.asarray(tp.poss[start : start + tf[f]], dtype=np.int64))
            start += tf[f]
        return out

    def _avg_len(self, shard: Shard) -> float:
        lex = shard.lexical
        if lex and lex.doc_count:
            return lex.avg_len
        l0 = shard.level0
        return l0.positions_sum_normalized / max(l0.doc_count, 1)

    # ------------------------------------------------------------------
    def set_synonyms(self, synonyms: list[dict]) -> None:
        """Replace the synonym set; applies to future indexing
        (reference synonyms set/add api_endpoints.rs:507-523)."""
        self.synonyms = list(synonyms)
        m: dict[str, set] = {}
        for syn in self.synonyms:
            terms = [t for raw in syn.get("terms", [])
                     for t in self.analyzer.analyze(raw)[:1]]
            if len(terms) < 2:
                continue
            if syn.get("multiway", True):
                for t in terms:
                    m.setdefault(t, set()).update(x for x in terms if x != t)
            else:
                # one-way: later terms also indexed under the first term
                for t in terms[1:]:
                    m.setdefault(t, set()).add(terms[0])
        self._synonym_map = m
        if self._native and self._native_cfg is not None:
            self._native_cfg.set_synonyms(m)
        elif self._native:
            self._get_native_cfg()
        self.save_meta()

    def add_synonyms(self, synonyms: list[dict]) -> None:
        self.set_synonyms(list(self.synonyms) + list(synonyms))

    # ------------------------------------------------------------------
    def get_iterator(
        self,
        document_id: int | None = None,
        skip: int = 0,
        take: int = 1,
        include_deleted: bool = False,
        include_document: bool = False,
        fields: list | None = None,
    ) -> list:
        """Skip/take doc-id iteration, forward (take>0) or backward (take<0),
        tolerant of gaps (reference GetIterator iterator.rs:65-91).

        Returns a list of doc ids, or (doc_id, doc) pairs when
        include_document is set."""
        self.ensure_loaded()

        def _valid(g: int) -> bool:
            shard = self.shards[g % self.shard_count]
            local = g // self.shard_count
            if local >= shard.doc_count:
                return False
            return include_deleted or local not in shard.deleted

        out = []
        if take >= 0:
            g = 0 if document_id is None else int(document_id)
            remaining_skip = skip
            while g < self.docid_global and len(out) < take:
                if _valid(g):
                    if remaining_skip > 0:
                        remaining_skip -= 1
                    else:
                        out.append(g)
                g += 1
        else:
            g = self.docid_global - 1 if document_id is None else int(document_id)
            remaining_skip = skip
            want = -take
            while g >= 0 and len(out) < want:
                if _valid(g):
                    if remaining_skip > 0:
                        remaining_skip -= 1
                    else:
                        out.append(g)
                g -= 1
        if include_document:
            result = []
            for g in out:
                doc = self.get_document(g)
                if doc is not None and fields:
                    doc = {k: v for k, v in doc.items() if k in fields}
                result.append((g, doc))
            return result
        return out

    # ------------------------------------------------------------------
    def info(self) -> dict:
        """Index statistics (reference display_index_info ingest.rs:639)."""
        import os as _os

        def dir_size(p):
            total = 0
            for root, _, files in _os.walk(p):
                for f in files:
                    try:
                        total += _os.path.getsize(_os.path.join(root, f))
                    except OSError:
                        pass
            return total

        postings = sum(len(sh.lexical.pl_docid) for sh in self.shards)
        terms = sum(
            len(sh.lexical.directory.hash) if sh.lexical.directory else 0
            for sh in self.shards
        )
        # the reference's count (its index.py info): every level's rows
        # plus level0, so a partial level's rows, which sit in both, count
        # twice; the port keeps that number
        vectors = 0
        if self.vectors is not None:
            vectors = sum(
                sum(lv.n for lv in sv.levels) + len(sv.level0)
                for sv in self.vectors.shards
            )
        return {
            "id": self.meta.id,
            "name": self.meta.name,
            "shard_count": self.shard_count,
            "indexed_doc_count": self.indexed_doc_count,
            "committed_doc_count": self.committed_doc_count,
            "deleted_doc_count": self.deleted_doc_count,
            "current_doc_count": self.current_doc_count,
            "term_count": int(terms),
            "posting_count": int(postings),
            "vector_count": int(vectors),
            "levels": [
                sh.full_levels + (1 if sh.partial_on_disk else 0)
                for sh in self.shards
            ],
            "index_size_bytes": dir_size(self.path),
            "tokenizer": self.meta.tokenizer.value,
            "similarity": self.meta.similarity.value,
            "access_type": self.meta.access_type.value,
        }

    # ------------------------------------------------------------------
    def precompile(self, **kw) -> int:
        """The reference compiles its device scan for a grid of plan shapes
        here.  Nothing is compiled ahead on this backend: PyTorch runs
        eagerly, whatever the shapes of a plan, and the CUDA kernels build
        once at first use (``_build.py``).  Accepts the reference's keywords
        and returns 0, the number of shapes compiled."""
        return 0

    def warmup(self, k: int = 1000, batch: int = 256) -> None:
        """Precompute cached results for every frequent word present in the
        index (reference warmup index.rs:4006-4058, invoked from commit
        commit.rs:148): top-k doc ids + scores + exact counts, and the
        string-facet histograms over all matching docs (the reference
        caches `facets` alongside the result page, index.rs:4035-4050),
        served to single-term queries, faceted or not, without a device
        dispatch.  Runs through the port's search_batch on the index's
        device.  A delete while it runs leaves the cache empty: the pages
        it computed may hold the deleted doc."""
        from .ops.wand import _signature
        from .search import (QueryFacet, ResultType, SearchRequest,
                             search_batch)

        sig = _signature(self)

        present = []
        for w in sorted(self._frequent_words):
            h = term_hash(w)
            if any(sh.lexical.directory is not None
                   and sh.lexical.directory.lookup(h) >= 0
                   for sh in self.shards):
                present.append(w)
        # plain string-facet histograms (reference get_index_string_facets
        # semantics): every string/stringset facet field, full depth
        facet_specs = [
            QueryFacet(field=sf.field, length=k)
            for sf in self.facet_fields
            if sf.field_type.is_string_facet
        ]
        cache: dict[int, tuple] = {}
        for i in range(0, len(present), batch):
            chunk = present[i : i + batch]
            reqs = [
                SearchRequest(query=w, length=k, realtime=False,
                              result_type=ResultType.TopkCount,
                              query_facets=list(facet_specs))
                for w in chunk
            ]
            for w, rs in zip(chunk, search_batch(self, reqs, self.device)):
                cache[term_hash(w)] = (
                    np.array([r.score for r in rs.results], np.float32),
                    np.array([r.doc_id for r in rs.results], np.int64),
                    rs.result_count_total,
                    dict(rs.facets),
                )
        with self._warm_lock:
            if _signature(self) == sig:
                self._warmup_k = k
                self._warmup_cache = cache

    # ------------------------------------------------------------------
    def attach_mesh(self, mesh=None) -> None:
        """Attach a device mesh (a ``parallel/mesh.Mesh`` or a list of torch
        devices): shard ranges are spread over its positions, every search
        runs on them and merges on the lead device.  With mesh=None, the
        largest count of the index's device family that divides
        shard_count: ``cuda:0 .. cuda:n-1`` of the host's cards, or the one
        ``cpu``.  The device state is rebuilt for the mesh."""
        from .parallel.mesh import Mesh, make_mesh

        if mesh is None:
            if self.device.type == "cuda":
                import torch

                # no card: Mesh refuses "cuda" as resolve_device does
                devs = [f"cuda:{i}" for i in range(
                    torch.cuda.device_count())] or ["cuda"]
            else:
                devs = ["cpu"]
            n = max(d for d in range(1, len(devs) + 1)
                    if self.shard_count % d == 0)
            mesh = make_mesh(devs[:n])
        elif not isinstance(mesh, Mesh):
            mesh = make_mesh(mesh)
        if self.shard_count % mesh.devices.size:
            raise ValueError(f"a mesh of {mesh.devices.size} positions does "
                             f"not divide {self.shard_count} shards")
        with self._lock:
            self._mesh = mesh
            for name in ("_torch_wand_states", "_torch_dense_states"):
                self.__dict__.pop(name, None)

    # ------------------------------------------------------------------
    def clear(self) -> None:
        """Remove all documents, keep schema/meta (reference clear_index)."""
        with self._lock:
            facet_ids = [f.facet_id for f in self.facet_fields]
            for sh in self.shards:
                if sh.path.exists():
                    for child in sh.path.iterdir():
                        if child.is_dir():
                            shutil.rmtree(child)
                        else:
                            child.unlink()
                sh.level0 = self._new_level0()
                sh.full_levels = 0
                sh.partial_on_disk = 0
                sh.deleted = set()
                sh._level_cache = {}
                sh.lexical = build_shard_lexical([], self.boosts_or_default())
                sh.docstores = []
                sh.facet_cols = {}
                sh._dev = None
            self.docid_global = 0
            self._facet_tables = {}
            from .rewrite import PruningRadixTrie, SymSpell

            if self.spell is not None:
                sc = self.meta.spelling_correction
                self.spell = SymSpell(
                    max_edit=sc.max_dictionary_edit_distance,
                    count_threshold=sc.count_threshold,
                    max_entries=sc.max_dictionary_entries,
                )
                (self.path / "dictionary.csv").unlink(missing_ok=True)
            if self.completions is not None:
                self.completions = PruningRadixTrie(
                    max_entries=self.meta.query_completion.max_completion_entries
                )
                (self.path / "completions.csv").unlink(missing_ok=True)
            if self.vectors is not None:
                self.vectors.clear()
            self.save_meta()

    def close(self) -> None:
        self.commit()

    def delete_index(self) -> None:
        if self.path.exists():
            shutil.rmtree(self.path)


# ----------------------------------------------------------------------
# lifecycle functions (reference create_index index.rs:1886 / open_index :3832)

def create_index(
    path,
    schema: list[SchemaField],
    meta: IndexMeta | None = None,
    shard_count: int = 1,
    synonyms: list | None = None,
    device="cuda",
) -> Index:
    """A new index at `path` whose device work (commit's warmup) runs on
    `device`; "cuda" without a card raises."""
    meta = meta or IndexMeta()
    path = Path(path)
    if (path / "index.json").exists():
        raise FileExistsError(f"index already exists at {path}")
    idx = Index(path, schema, meta, shard_count, serialize=True,
                device=device)
    if synonyms:
        idx.set_synonyms(synonyms)
    if meta.vector.enabled:
        from .vector_index import IndexVectors

        idx.vectors = IndexVectors(idx)
    # persist facet string tables
    _save_facet_tables(idx)
    return idx


def open_index(path, device="cuda") -> Index:
    """The index at `path`, bound to `device` as create_index binds it."""
    path = Path(path)
    with open(path / "index.json") as f:
        root = json.load(f)
    meta = IndexMeta.from_json(root["meta"])
    with open(path / "schema.json") as f:
        schema = schema_from_json(f.read())
    idx = Index(path, schema, meta, root["shard_count"], serialize=False,
                device=device)
    idx.docid_global = root["docid_global"]
    syn_path = path / "synonyms.json"
    if syn_path.exists():
        with open(syn_path) as f:
            syns = json.load(f)
        if syns:
            idx.set_synonyms(syns)
    from .rewrite import PruningRadixTrie, SymSpell

    dict_path = path / "dictionary.csv"
    if idx.spell is not None and dict_path.exists():
        sc = meta.spelling_correction
        idx.spell = SymSpell.load(
            dict_path,
            max_edit=sc.max_dictionary_edit_distance,
            count_threshold=sc.count_threshold,
            max_entries=sc.max_dictionary_entries,
        )
    comp_path = path / "completions.csv"
    if idx.completions is not None and comp_path.exists():
        idx.completions = PruningRadixTrie.load(
            comp_path,
            max_entries=meta.query_completion.max_completion_entries,
        )
    ft_path = path / "facet_tables.json"
    if ft_path.exists():
        with open(ft_path) as f:
            raw = json.load(f)
        if "values" in raw:
            idx._facet_tables = {int(k): v for k, v in raw["values"].items()}
            idx._facet_set_tables = {
                int(k): {
                    tuple(int(x) for x in m.split(",") if x): v
                    for m, v in t.items()
                }
                for k, t in raw.get("sets", {}).items()
            }
        else:  # legacy format
            idx._facet_tables = {int(k): v for k, v in raw.items()}
    for sh in idx.shards:
        sj = sh.path / "shard.json"
        if sj.exists():
            with open(sj) as f:
                st = json.load(f)
            sh.full_levels = st["full_levels"]
            sh.partial_on_disk = st["partial_on_disk"]
        dp = sh.path / "deleted.npy"
        if dp.exists():
            sh.deleted = set(np.load(dp).tolist())
        idx._reload_shard(sh)
        # reload partial level into RAM so the next commit can rewrite it
        if sh.partial_on_disk:
            lvl_id = sh.full_levels
            lvl = sh.lexical.levels[lvl_id]
            cls = NativeLevel0 if idx._native else Level0
            sh.level0 = cls.from_level(
                lvl,
                sh.path / f"level_{lvl_id}",
                [f.facet_id for f in idx.facet_fields],
                sh.n_fields,
            )
        else:
            sh.level0 = idx._new_level0()
    if meta.vector.enabled:
        from .vector_index import IndexVectors

        idx.vectors = IndexVectors(idx)
        idx.vectors.load()
    return idx


def _save_facet_tables(idx: Index) -> None:
    tables = getattr(idx, "_facet_tables", {})
    sets = getattr(idx, "_facet_set_tables", {})
    with open(idx.path / "facet_tables.json", "w") as f:
        json.dump(
            {
                "values": {str(k): v for k, v in tables.items()},
                "sets": {
                    str(k): {",".join(map(str, m)): v for m, v in t.items()}
                    for k, t in sets.items()
                },
            },
            f,
        )
