"""The port's ingest layer (``seekstorm_tpu_torch``'s ``pdftext``,
``ingest``, ``docstore`` and ``api_types``) against the JAX package's, on
the CPU.

  * The 5 behaviours of ``tests/test_pdf.py`` through the port: the text
    and metadata its extractor finds are the reference's, a PDF ingests and
    is found, and Lz4 doc compression is the real codec.
  * ``tests/test_misc.py::test_distance_fields_api`` through the port's
    ``api_types``, with the reference's distances.
  * ``ingest_file`` on JSON (array, NDJSON, concatenated) and CSV: the
    same documents in both packages, and the same pages.
  * ``read_fvecs``/``read_ivecs`` and ``ingest_sift``/``search_sift`` on
    tiny files the test writes: the same vectors, the same recall.
"""

import json
import types
import zlib

import numpy as np
import pytest

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu import api_types as ref_api
from seekstorm_tpu import ingest as ref_ingest
from seekstorm_tpu.pdftext import extract_text as ref_extract
from seekstorm_tpu_torch import api_types as port_api
from seekstorm_tpu_torch import ingest as port_ingest
from seekstorm_tpu_torch.pdftext import extract_text
from test_pdf import make_pdf
from test_torch_native import native_for_both


@pytest.fixture(scope="module", autouse=True)
def _native_library():
    """Both packages on the native library (test_torch_native's
    native_for_both)."""
    native_for_both()


def _both_extract(pdf):
    got = extract_text(pdf)
    assert got == ref_extract(pdf)
    return got


def test_extract_text_flate_with_info():
    pdf = make_pdf(["Hello TPU search engine", "second line of text"],
                   title="My Report")
    text, meta = _both_extract(pdf)
    assert "Hello TPU search engine" in text
    assert "second line of text" in text
    assert meta["title"] == "My Report"
    assert meta["creation_date"] == "2024-03-01"


def test_extract_text_uncompressed_title_heuristic():
    pdf = make_pdf(["First Line Title", "body words here"], title=None,
                   compress=False)
    text, meta = _both_extract(pdf)
    assert "body words here" in text
    assert meta["title"] == "First Line Title"


def test_extract_tj_array_and_escapes():
    content = (rb"BT /F1 10 Tf [(spl) -20 (it ar) 5 (ray)] TJ "
               rb"0 -14 Td (par\(en\) and \101BC) Tj ET")
    data = zlib.compress(content)
    head = (b"%PDF-1.4\n"
            b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n"
            b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 >>\nendobj\n"
            b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Contents 4 0 R >>"
            b"\nendobj\n"
            b"4 0 obj\n<< /Length " + str(len(data)).encode()
            + b" /Filter /FlateDecode >>\nstream\n")
    doc = (head + data + b"\nendstream\nendobj\n"
           b"trailer\n<< /Size 5 /Root 1 0 R >>\n%%EOF\n")
    text, _ = _both_extract(doc)
    assert "split array" in text.replace("\n", " ")
    assert "par(en) and ABC" in text


def _text_schema(pkg):
    return [pkg.SchemaField("title", pkg.FieldType.Text, stored=True,
                            indexed=True),
            pkg.SchemaField("body", pkg.FieldType.Text, stored=True,
                            indexed=True)]


def test_ingest_pdf_roundtrip(tmp_path):
    pdf = make_pdf(["quantum flibbertigibbet retrieval"], title="Qdoc")
    p = tmp_path / "doc.pdf"
    p.write_bytes(pdf)
    out = []
    for pkg, mod, name in ((st, ref_ingest, "ref"), (pt, port_ingest, "pt")):
        kw = {"device": "cpu"} if pkg is pt else {}
        idx = pkg.create_index(tmp_path / name, _text_schema(pkg),
                               shard_count=1, **kw)
        assert mod.ingest_file(idx, p) == 1
        idx.commit()
        rs = idx.search(pkg.SearchRequest(query="flibbertigibbet",
                                          fields=["title", "body"]))
        assert rs.result_count == 1
        assert rs.results[0].doc["title"] == "Qdoc"
        out.append([(r.doc_id, r.score, r.doc) for r in rs.results])
    assert out[0] == out[1]


def test_lz4_docstore_roundtrip(tmp_path):
    """Lz4 doc compression is the in-repo C++ block codec in the port too,
    and its blobs are the reference's, byte for byte."""
    from seekstorm_tpu import docstore as ref_store
    from seekstorm_tpu_torch.docstore import compress_doc, resolve_codec

    lz4 = pt.DocumentCompression.Lz4
    assert resolve_codec(lz4) == lz4
    doc = {"body": "document number 0 with repeated repeated text"}
    assert compress_doc(doc, lz4) == ref_store.compress_doc(
        doc, st.DocumentCompression.Lz4)

    schema = [pt.SchemaField("body", pt.FieldType.Text, stored=True,
                             indexed=True)]
    meta = pt.IndexMeta(doc_compression=lz4)
    idx = pt.create_index(tmp_path / "ix", schema, meta=meta, shard_count=1,
                          device="cpu")
    docs = [{"body": f"document number {i} with repeated repeated text"}
            for i in range(50)]
    idx.index_documents(docs)
    idx.commit()
    assert idx.get_document(0)["body"].startswith("document number 0")
    idx2 = pt.open_index(tmp_path / "ix", device="cpu")
    assert idx2.get_document(49)["body"].startswith("document number")
    # an index the port wrote opens in the reference
    assert st.open_index(tmp_path / "ix").get_document(49) == docs[49]


def test_distance_fields_api(tmp_path):
    got = []
    for pkg, api, name in ((st, ref_api, "ref"), (pt, port_api, "pt")):
        kw = {"device": "cpu"} if pkg is pt else {}
        idx = pkg.create_index(
            tmp_path / name,
            [pkg.SchemaField("t", pkg.FieldType.Text, stored=True,
                             indexed=True),
             pkg.SchemaField("loc", pkg.FieldType.Point, stored=True,
                             facet=True)], **kw)
        idx.index_documents([
            {"t": "place one", "loc": [48.8566, 2.3522]},   # Paris
            {"t": "place two", "loc": [51.5074, -0.1278]},  # London
        ])
        idx.commit()
        # an uncommitted doc: both packages read the padding of the
        # committed facet column for it, not its point (the reference's
        # fault, kept by the port), so only the two are compared
        idx.index_document({"t": "place three", "loc": [52.52, 13.405]})
        df = api.DistanceField(field="loc", distance="dist_km",
                               base=[48.8566, 2.3522], unit="Kilometers")
        doc = api.apply_distance_fields(idx, [df], 1, {"t": "place two"})
        assert 300 < doc["dist_km"] < 400   # Paris-London ~344 km
        doc0 = api.apply_distance_fields(idx, [df], 0, {})
        assert doc0["dist_km"] < 1.0
        dfm = api.DistanceField(field="loc", distance="dist_mi",
                                base=[48.8566, 2.3522], unit="Miles")
        docm = api.apply_distance_fields(idx, [dfm], 1, {})
        assert 190 < docm["dist_mi"] < 250
        tail = api.apply_distance_fields(idx, [df], 2, {})
        got.append((doc, doc0, docm, tail))
    assert got[0] == got[1]


_ROWS = [{"title": f"row w{i % 7:03d} title", "body": f"w{i % 11:03d} body "
          f"w{i % 5:03d}", "n": str(i)} for i in range(40)]


def _write(path, fmt):
    if fmt == "array":
        path.write_text(json.dumps(_ROWS))
    elif fmt == "ndjson":
        path.write_text("".join(json.dumps(r) + "\n" for r in _ROWS))
    elif fmt == "concatenated":
        path.write_text(" ".join(json.dumps(r, indent=1) for r in _ROWS))
    else:
        path.write_text("title,body,n\n" + "".join(
            f"{r['title']},{r['body']},{r['n']}\n" for r in _ROWS))


@pytest.mark.parametrize("fmt", ["array", "ndjson", "concatenated", "csv"])
def test_ingest_file_formats(tmp_path, fmt):
    src = tmp_path / ("docs.csv" if fmt == "csv" else "docs.json")
    _write(src, fmt)
    head = src.read_bytes()[:65536]
    if fmt != "csv":
        assert port_ingest.detect_json_format(head) == fmt == \
            ref_ingest.detect_json_format(head)
    pages = []
    for pkg, mod, name in ((st, ref_ingest, "ref"), (pt, port_ingest, "pt")):
        kw = {"device": "cpu"} if pkg is pt else {}
        idx = pkg.create_index(tmp_path / name, _text_schema(pkg),
                               shard_count=2, **kw)
        assert mod.ingest_file(idx, src, batch_size=16) == len(_ROWS)
        idx.commit()
        assert idx.indexed_doc_count == len(_ROWS)
        assert [idx.get_document(i)["title"] for i in range(len(_ROWS))] \
            == [r["title"] for r in _ROWS]
        rs = idx.search(pkg.SearchRequest(query="w003", length=50,
                                          result_type=pkg.ResultType.TopkCount))
        pages.append((rs.result_count_total,
                      [(r.doc_id, r.score) for r in rs.results]))
    assert pages[0] == pages[1]
    assert pages[0][0] > 0


def _fvecs(path, x):
    x = np.asarray(x)
    d = x.shape[1]
    rows = np.empty((len(x), d + 1), np.int32)
    rows[:, 0] = d
    rows[:, 1:] = x.view(np.int32)
    rows.tofile(path)


def test_sift_loaders_and_harness(tmp_path):
    rng = np.random.default_rng(11)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    queries = base[:12] + 0.01 * rng.standard_normal((12, 16)).astype(
        np.float32)
    d2 = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :10].astype(np.int32)
    _fvecs(tmp_path / "sift_base.fvecs", base)
    _fvecs(tmp_path / "sift_query.fvecs", queries)
    _fvecs(tmp_path / "sift_groundtruth.ivecs", truth.view(np.float32))

    got = port_ingest.read_fvecs(tmp_path / "sift_base.fvecs", 100)
    np.testing.assert_array_equal(got, base[:100])
    np.testing.assert_array_equal(
        port_ingest.read_ivecs(tmp_path / "sift_groundtruth.ivecs"), truth)
    np.testing.assert_array_equal(
        port_ingest.read_fvecs(tmp_path / "sift_query.fvecs"),
        ref_ingest.read_fvecs(tmp_path / "sift_query.fvecs"))
    empty = tmp_path / "empty.fvecs"
    empty.write_bytes(b"")
    assert port_ingest.read_fvecs(empty).shape == (0, 0)

    recalls = []
    for mod, name, dev in ((ref_ingest, "ref", None),
                           (port_ingest, "pt", "cpu")):
        server = types.SimpleNamespace(root=tmp_path / name, device=dev)
        ak = types.SimpleNamespace(apikey_hash="k", index_list={})
        ix, n = mod.ingest_sift(server, ak, tmp_path)
        assert n == 300 and ak.index_list[0] is ix
        recall, lat = mod.search_sift(ix, tmp_path, nprobe=0,
                                      max_queries=12)
        assert lat > 0
        recalls.append(recall)
    assert recalls[0] == recalls[1] >= 0.9
