"""Ingestion: JSON / NDJSON / concatenated-JSON / CSV autodetect, SIFT
fvecs/ivecs benchmark loaders + recall harness.

Mirrors the reference ingestion surface (reference seekstorm/src/ingest.rs —
IngestJson :547 stream autodetect, IngestCsv :1013, read_ivecs :1145,
read_fvecs :1172, ingest_sift :1202; recall harness seekstorm_server/src/
server.rs:455-565 searchsift).  PDF ingestion is gated on a pdf text
extractor being available (pypdf); the reference uses pdfium.

The port's copy of ``seekstorm_tpu/ingest.py``.  What differs: ``ingest_sift``
creates its index on the server's device (``server.device``), and
``search_sift`` searches through ``Index.search``, which runs on the index's
own device.
"""

from __future__ import annotations

import csv
import io
import json
import time
from pathlib import Path

import numpy as np


def detect_json_format(head: bytes) -> str:
    """'array' | 'ndjson' | 'concatenated'."""
    stripped = head.lstrip()
    if stripped.startswith(b"["):
        return "array"
    # ndjson: one object per line; concatenated: objects back to back
    first_nl = head.find(b"\n")
    if first_nl > 0:
        line = head[:first_nl].strip()
        if line.startswith(b"{") and line.endswith(b"}"):
            try:
                json.loads(line)
                return "ndjson"
            except Exception:
                pass
    return "concatenated"


def iter_json_docs(path):
    """Yield documents from a JSON / NDJSON / concatenated-JSON file
    (reference IngestJson ingest.rs:547 autodetect)."""
    p = Path(path)
    with open(p, "rb") as f:
        head = f.read(64 * 1024)
    fmt = detect_json_format(head)
    if fmt == "array":
        with open(p, "r", encoding="utf-8") as f:
            for doc in json.load(f):
                yield doc
    elif fmt == "ndjson":
        with open(p, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)
    else:
        dec = json.JSONDecoder()
        with open(p, "r", encoding="utf-8") as f:
            buf = f.read()
        i = 0
        n = len(buf)
        while i < n:
            while i < n and buf[i] in " \t\r\n":
                i += 1
            if i >= n:
                break
            doc, end = dec.raw_decode(buf, i)
            yield doc
            i = end


def iter_csv_docs(path, delimiter=","):
    """Yield documents from a CSV with a header row (reference IngestCsv)."""
    with open(path, "r", encoding="utf-8", newline="") as f:
        for row in csv.DictReader(f, delimiter=delimiter):
            yield dict(row)


def ingest_file(index, path, batch_size: int = 1024) -> int:
    """Autodetect + ingest a file into an index. Returns doc count."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".csv":
        it = iter_csv_docs(p)
    elif suffix == ".tsv":
        it = iter_csv_docs(p, delimiter="\t")
    elif suffix == ".pdf":
        return ingest_pdf(index, p)
    else:
        it = iter_json_docs(p)
    n = 0
    batch = []
    for doc in it:
        batch.append(doc)
        if len(batch) >= batch_size:
            index.index_documents(batch)
            n += len(batch)
            batch = []
    if batch:
        index.index_documents(batch)
        n += len(batch)
    return n


def ingest_pdf(index, path) -> int:
    """PDF ingestion (reference IndexPdfFile ingest.rs:79-156) via the
    in-repo extractor (pdftext.py; the reference uses pdfium)."""
    from .pdftext import extract_text

    data = Path(path).read_bytes()
    text, meta = extract_text(data)
    title = meta.get("title") or Path(path).name
    doc = {"title": title, "body": text, "file": str(path)}
    if meta.get("creation_date"):
        doc["date"] = meta["creation_date"]
    index.index_document(doc)
    return 1


def ingest_pdf_dir(index, root) -> int:
    """Recursive PDF directory ingestion (reference IngestPdf
    ingest.rs:459, path_recurse :430)."""
    n = 0
    for p in sorted(Path(root).rglob("*.pdf")):
        try:
            n += ingest_pdf(index, p)
        except Exception:
            continue
    return n


# ---------------------------------------------------------------------------
# SIFT benchmark loaders (reference ingest.rs:1145-1262)

def read_fvecs(path, max_rows: int | None = None) -> np.ndarray:
    """fvecs: per row [d:i32][d x f32]."""
    raw = np.fromfile(path, dtype=np.int32)
    if len(raw) == 0:
        return np.zeros((0, 0), np.float32)
    d = raw[0]
    raw = raw.reshape(-1, d + 1)
    if max_rows:
        raw = raw[:max_rows]
    return raw[:, 1:].view(np.float32).copy()


def read_ivecs(path, max_rows: int | None = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    if len(raw) == 0:
        return np.zeros((0, 0), np.int32)
    d = raw[0]
    raw = raw.reshape(-1, d + 1)
    if max_rows:
        raw = raw[:max_rows]
    return raw[:, 1:].copy()


def ingest_sift(server, ak, sift_dir, index_id=None, max_rows=None):
    """Build a SIFT vector index (Euclidean, SQ-i8, Auto clustering) from
    <dir>/sift_base.fvecs (reference server.rs:740 ingestsift)."""
    from .index import create_index
    from .schema import (
        ClusteringConfig,
        ClusteringMode,
        FieldType,
        IndexMeta,
        InferenceType,
        Precision,
        Quantization,
        SchemaField,
        VectorConfig,
        VectorSimilarity,
    )

    base = read_fvecs(Path(sift_dir) / "sift_base.fvecs", max_rows)
    d = base.shape[1]
    if index_id is None:
        index_id = max(ak.index_list.keys(), default=-1) + 1
    meta = IndexMeta(
        id=index_id,
        name="sift",
        vector=VectorConfig(
            enabled=True, dim=d, similarity=VectorSimilarity.Euclidean,
            precision=Precision.I8,
            quantization=Quantization.ScalarQuantizationI8,
            inference=InferenceType.External,
            clustering=ClusteringConfig(mode=ClusteringMode.Auto),
        ),
    )
    schema = [SchemaField("vector", FieldType.Json, index_vector=True)]
    ix = create_index(
        server.root / ak.apikey_hash / str(index_id), schema, meta=meta,
        shard_count=1, device=server.device,
    )
    for i in range(len(base)):
        ix.index_document({"vector": base[i].tolist()})
    ix.commit()
    ak.index_list[index_id] = ix
    return ix, len(base)


def search_sift(index, sift_dir, nprobe: int = 16, max_queries: int = 100):
    """recall@10 + latency vs SIFT ground truth (reference server.rs:455-565).

    Returns (recall, avg_latency_us)."""
    from .search import ResultType, SearchMode, SearchRequest

    queries = read_fvecs(Path(sift_dir) / "sift_query.fvecs", max_queries)
    truth = read_ivecs(Path(sift_dir) / "sift_groundtruth.ivecs", max_queries)
    hits = 0
    t0 = time.perf_counter()
    for qi in range(len(queries)):
        rs = index.search(
            SearchRequest(
                search_mode=SearchMode.Vector,
                query_vector=queries[qi].tolist(),
                length=10,
                ann_mode="Nprobe" if nprobe else "All",
                nprobe=nprobe,
                result_type=ResultType.Topk,
                realtime=False,
            )
        )
        got = {r.doc_id for r in rs.results}
        hits += len(got & set(truth[qi][:10].tolist()))
    dt = time.perf_counter() - t0
    n = max(len(queries), 1)
    return hits / (10 * n), dt / n * 1e6
