"""Schema & configuration types.

Mirrors the semantics of the reference engine's schema/config surface
(reference: seekstorm/src/index.rs:1007-1420 — FieldType, SchemaField,
IndexMetaObject, tokenizer/similarity/stopword enums) re-expressed as
plain Python dataclasses with JSON (de)serialization.  Nothing here runs
on device; these objects configure how the host packs index tensors.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Optional


class FieldType(str, enum.Enum):
    """Field data types (reference index.rs:1007-1075)."""

    U8 = "U8"
    U16 = "U16"
    U32 = "U32"
    U64 = "U64"
    I8 = "I8"
    I16 = "I16"
    I32 = "I32"
    I64 = "I64"
    F32 = "F32"
    F64 = "F64"
    Timestamp = "Timestamp"
    Bool = "Bool"
    String16 = "String16"
    String32 = "String32"
    StringSet16 = "StringSet16"
    StringSet32 = "StringSet32"
    Point = "Point"
    Text = "Text"
    Json = "Json"
    Binary = "Binary"

    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC_TYPES

    @property
    def is_string_facet(self) -> bool:
        return self in (
            FieldType.String16,
            FieldType.String32,
            FieldType.StringSet16,
            FieldType.StringSet32,
        )


_NUMERIC_TYPES = {
    FieldType.U8,
    FieldType.U16,
    FieldType.U32,
    FieldType.U64,
    FieldType.I8,
    FieldType.I16,
    FieldType.I32,
    FieldType.I64,
    FieldType.F32,
    FieldType.F64,
    FieldType.Timestamp,
    FieldType.Bool,
}

# numpy dtype for each numeric facet column (host + device layouts)
FACET_DTYPES = {
    FieldType.U8: "u1",
    FieldType.U16: "u2",
    FieldType.U32: "u4",
    FieldType.U64: "u8",
    FieldType.I8: "i1",
    FieldType.I16: "i2",
    FieldType.I32: "i4",
    FieldType.I64: "i8",
    FieldType.F32: "f4",
    FieldType.F64: "f8",
    FieldType.Timestamp: "i8",
    FieldType.Bool: "u1",
    FieldType.String16: "u2",
    FieldType.String32: "u4",
    FieldType.StringSet16: "u2",
    FieldType.StringSet32: "u4",
    FieldType.Point: "f8",  # stored as 2 x f64 (lat, lon) -> morton u64 column
}


class TokenizerType(str, enum.Enum):
    """Tokenizer families (reference index.rs:600-624)."""

    AsciiAlphabetic = "AsciiAlphabetic"
    UnicodeAlphanumeric = "UnicodeAlphanumeric"
    UnicodeAlphanumericFolded = "UnicodeAlphanumericFolded"
    Whitespace = "Whitespace"
    WhitespaceLowercase = "WhitespaceLowercase"
    UnicodeAlphanumericZH = "UnicodeAlphanumericZH"


class StemmerType(str, enum.Enum):
    """Stemmer selection — all 38 languages of the reference
    (reference index.rs:642-721 StemmerType).  Implementations live in
    stemmers.py: exact Snowball (NLTK) for the major languages, published
    light-stemmer rule sets for the rest; English/Porter use the in-repo
    Porter implementation mirrored in the C++ tokenizer."""

    Null = "None"
    Arabic = "Arabic"
    Armenian = "Armenian"
    Basque = "Basque"
    Catalan = "Catalan"
    Czech = "Czech"
    Danish = "Danish"
    Dutch = "Dutch"
    DutchPorter = "DutchPorter"
    English = "English"
    Esperanto = "Esperanto"
    Estonian = "Estonian"
    Finnish = "Finnish"
    French = "French"
    German = "German"
    Greek = "Greek"
    Hindi = "Hindi"
    Hungarian = "Hungarian"
    Indonesian = "Indonesian"
    Irish = "Irish"
    Italian = "Italian"
    Lithuanian = "Lithuanian"
    Lovins = "Lovins"
    Nepali = "Nepali"
    Norwegian = "Norwegian"
    Persian = "Persian"
    Polish = "Polish"
    Porter = "Porter"
    Portuguese = "Portuguese"
    Romanian = "Romanian"
    Russian = "Russian"
    Serbian = "Serbian"
    Sesotho = "Sesotho"
    Spanish = "Spanish"
    Swedish = "Swedish"
    Tamil = "Tamil"
    Turkish = "Turkish"
    Ukrainian = "Ukrainian"
    Yiddish = "Yiddish"


class StopwordType(str, enum.Enum):
    """Stopword handling (reference index.rs:1239)."""

    Null = "None"
    English = "English"
    German = "German"
    French = "French"
    Spanish = "Spanish"
    Custom = "Custom"


class FrequentwordType(str, enum.Enum):
    """Frequent-word list used for n-gram indexing (reference index.rs:1262)."""

    Null = "None"
    English = "English"
    German = "German"
    French = "French"
    Spanish = "Spanish"
    Custom = "Custom"


class LexicalSimilarity(str, enum.Enum):
    """(reference index.rs:561-567)"""

    Bm25f = "Bm25f"
    Bm25fProximity = "Bm25fProximity"


class VectorSimilarity(str, enum.Enum):
    """(reference vector_similarity.rs:15)"""

    Cosine = "Cosine"
    Dot = "Dot"
    Euclidean = "Euclidean"


class Precision(str, enum.Enum):
    """Vector storage precision (reference vector.rs:34)."""

    F32 = "F32"
    I8 = "I8"


class Quantization(str, enum.Enum):
    """(reference vector.rs:232-250)"""

    Null = "None"
    ScalarQuantizationI8 = "ScalarQuantizationI8"
    TurboQuantI8 = "TurboQuantI8"


class AccessType(str, enum.Enum):
    """Ram keeps packed tensors resident; Mmap lazily maps from disk.

    On TPU both end up as HBM tensors after open; the distinction controls
    host-side residency of the doc store / positions (reference
    ARCHITECTURE.md:70-73).
    """

    Ram = "Ram"
    Mmap = "Mmap"


class DocumentCompression(str, enum.Enum):
    """Doc-store compression (reference doc_store.rs:80-103). Zlib replaces
    Snappy/Lz4/Zstd when those codecs are unavailable in the environment."""

    Null = "None"
    Zlib = "Zlib"
    Snappy = "Snappy"
    Lz4 = "Lz4"
    Zstd = "Zstd"


class ClusteringMode(str, enum.Enum):
    """IVF clustering config (reference index.rs:1317)."""

    Null = "None"
    Auto = "Auto"
    Fixed = "Fixed"


class InferenceType(str, enum.Enum):
    """Embedding inference (reference vector.rs:284-318). Round 1 supports
    External embeddings; Model2Vec inference lands with the model assets."""

    Null = "None"
    External = "External"
    Model2Vec = "Model2Vec"
    Model2VecCustom = "Model2VecCustom"


@dataclass
class SpellingCorrection:
    """SymSpell spelling-correction config (reference index.rs:1283-1307).
    max_dictionary_edit_distance == 0 disables correction."""

    max_dictionary_edit_distance: int = 0
    term_length_threshold: tuple | None = None
    count_threshold: int = 1
    max_dictionary_entries: int = 1_000_000

    @property
    def enabled(self) -> bool:
        return self.max_dictionary_edit_distance > 0

    def to_json(self):
        return {
            "max_dictionary_edit_distance": self.max_dictionary_edit_distance,
            "term_length_threshold": list(self.term_length_threshold)
            if self.term_length_threshold else None,
            "count_threshold": self.count_threshold,
            "max_dictionary_entries": self.max_dictionary_entries,
        }

    @staticmethod
    def from_json(d) -> "SpellingCorrection":
        if d is None or d == "None":
            return SpellingCorrection()
        if d == "Low":
            return SpellingCorrection(max_dictionary_edit_distance=1)
        if d == "High":
            return SpellingCorrection(max_dictionary_edit_distance=2)
        tl = d.get("term_length_threshold")
        return SpellingCorrection(
            max_dictionary_edit_distance=d.get(
                "max_dictionary_edit_distance", 0),
            term_length_threshold=tuple(tl) if tl else None,
            count_threshold=d.get("count_threshold", 1),
            max_dictionary_entries=d.get("max_dictionary_entries", 1_000_000),
        )


@dataclass
class QueryCompletion:
    """Query auto-completion config (reference index.rs:1309-1314).
    max_completion_entries == 0 disables completion."""

    max_completion_entries: int = 0

    @property
    def enabled(self) -> bool:
        return self.max_completion_entries > 0

    def to_json(self):
        return {"max_completion_entries": self.max_completion_entries}

    @staticmethod
    def from_json(d) -> "QueryCompletion":
        if d is None or d == "None":
            return QueryCompletion()
        if d == "Enabled":
            return QueryCompletion(max_completion_entries=1_000_000)
        return QueryCompletion(
            max_completion_entries=d.get("max_completion_entries", 0))


@dataclass
class SchemaField:
    """One field of the index schema (reference index.rs:1102-1155)."""

    field: str
    field_type: FieldType = FieldType.Text
    stored: bool = False
    indexed: bool = False          # lexical indexing (reference: index)
    index_vector: bool = False     # vector indexing of this field's text
    facet: bool = False
    boost: float = 1.0
    longest_field: bool = False
    dictionary_source: bool = False
    completion_source: bool = False

    # assigned internally
    field_id: int = -1
    indexed_field_id: int = -1
    facet_id: int = -1

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["field_type"] = self.field_type.value
        return d

    @staticmethod
    def from_json(d: dict) -> "SchemaField":
        d = dict(d)
        d["field_type"] = FieldType(d["field_type"])
        return SchemaField(**d)


@dataclass
class ClusteringConfig:
    mode: ClusteringMode = ClusteringMode.Auto
    cluster_count: int = 0          # for Fixed
    min_points: int = 100           # below this, a level is left unclustered
    iterations: int = 8

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["mode"] = self.mode.value
        return d

    @staticmethod
    def from_json(d: dict) -> "ClusteringConfig":
        d = dict(d)
        d["mode"] = ClusteringMode(d["mode"])
        return ClusteringConfig(**d)


@dataclass
class VectorConfig:
    """Per-index vector-engine config (reference IndexMetaObject vector fields
    + vector.rs:232-318)."""

    enabled: bool = False
    dim: int = 0
    similarity: VectorSimilarity = VectorSimilarity.Cosine
    precision: Precision = Precision.I8
    quantization: Quantization = Quantization.ScalarQuantizationI8
    inference: InferenceType = InferenceType.External
    model: str = ""
    chunk_size: int = 1000
    clustering: ClusteringConfig = field(default_factory=ClusteringConfig)

    def to_json(self) -> dict:
        return {
            "enabled": self.enabled,
            "dim": self.dim,
            "similarity": self.similarity.value,
            "precision": self.precision.value,
            "quantization": self.quantization.value,
            "inference": self.inference.value,
            "model": self.model,
            "chunk_size": self.chunk_size,
            "clustering": self.clustering.to_json(),
        }

    @staticmethod
    def from_json(d: dict) -> "VectorConfig":
        return VectorConfig(
            enabled=d["enabled"],
            dim=d["dim"],
            similarity=VectorSimilarity(d["similarity"]),
            precision=Precision(d["precision"]),
            quantization=Quantization(d["quantization"]),
            inference=InferenceType(d["inference"]),
            model=d.get("model", ""),
            chunk_size=d.get("chunk_size", 1000),
            clustering=ClusteringConfig.from_json(d["clustering"]),
        )


@dataclass
class IndexMeta:
    """Index-level configuration (reference IndexMetaObject index.rs:1339-1420)."""

    id: int = 0
    name: str = "index"
    similarity: LexicalSimilarity = LexicalSimilarity.Bm25f
    tokenizer: TokenizerType = TokenizerType.UnicodeAlphanumeric
    stemmer: StemmerType = StemmerType.Null
    stop_words: StopwordType = StopwordType.Null
    custom_stop_words: tuple = ()
    frequent_words: FrequentwordType = FrequentwordType.Null
    custom_frequent_words: tuple = ()
    ngram_indexing: int = 0            # NgramSet bitflags (0 = off)
    access_type: AccessType = AccessType.Ram
    # default to a FAST codec like the reference (its default is Snappy,
    # index.rs doc_store_compression_default); Lz4 is served by the in-repo
    # C++ block codec at ~560/900 MB/s
    doc_compression: DocumentCompression = DocumentCompression.Lz4
    spelling_correction: SpellingCorrection = field(
        default_factory=SpellingCorrection)
    query_completion: QueryCompletion = field(default_factory=QueryCompletion)
    vector: VectorConfig = field(default_factory=VectorConfig)

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "name": self.name,
            "similarity": self.similarity.value,
            "tokenizer": self.tokenizer.value,
            "stemmer": self.stemmer.value,
            "stop_words": self.stop_words.value,
            "custom_stop_words": list(self.custom_stop_words),
            "frequent_words": self.frequent_words.value,
            "custom_frequent_words": list(self.custom_frequent_words),
            "ngram_indexing": self.ngram_indexing,
            "access_type": self.access_type.value,
            "doc_compression": self.doc_compression.value,
            "spelling_correction": self.spelling_correction.to_json(),
            "query_completion": self.query_completion.to_json(),
            "vector": self.vector.to_json(),
        }

    @staticmethod
    def from_json(d: dict) -> "IndexMeta":
        return IndexMeta(
            id=d.get("id", 0),
            name=d.get("name", "index"),
            similarity=LexicalSimilarity(d["similarity"]),
            tokenizer=TokenizerType(d["tokenizer"]),
            stemmer=StemmerType(d["stemmer"]),
            stop_words=StopwordType(d["stop_words"]),
            custom_stop_words=tuple(d.get("custom_stop_words", ())),
            frequent_words=FrequentwordType(d.get("frequent_words", "None")),
            custom_frequent_words=tuple(d.get("custom_frequent_words", ())),
            ngram_indexing=d.get("ngram_indexing", 0),
            access_type=AccessType(d["access_type"]),
            doc_compression=DocumentCompression(d["doc_compression"]),
            spelling_correction=SpellingCorrection.from_json(
                d.get("spelling_correction")),
            query_completion=QueryCompletion.from_json(
                d.get("query_completion")),
            vector=VectorConfig.from_json(d["vector"]),
        )


def schema_to_json(schema: list[SchemaField]) -> str:
    return json.dumps([f.to_json() for f in schema], indent=1)


def schema_from_json(s: str) -> list[SchemaField]:
    return [SchemaField.from_json(d) for d in json.loads(s)]


# BM25 constants (reference add_result.rs:20-22)
BM25_K = 1.2
BM25_B = 0.75
BM25_SIGMA = 0.0

# Documents per block/level (reference ROARING_BLOCK_SIZE index.rs:115)
BLOCK_SIZE = 65_536

# Cap on query terms (reference MAX_QUERY_TERM_NUMBER index.rs:121)
MAX_QUERY_TERMS = 100

INDEX_FORMAT_VERSION = 1
