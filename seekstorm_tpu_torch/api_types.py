"""JSON wire format for the REST API.

Field names mirror the reference's serde surface (reference
seekstorm/src/index.rs:137-258 SearchRequestObject / SearchResultObject,
:258-282 ApikeyQuotaObject, :1450-1459 DistanceField) so clients of the
reference server can talk to this one unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from . import geo
from .search import (
    FacetFilter,
    Highlight,
    QueryFacet,
    QueryType,
    Ranges,
    ResultSort,
    ResultType,
    SearchMode,
    SearchRequest,
)


@dataclass
class DistanceField:
    field: str
    distance: str
    base: list
    unit: str = "Kilometers"


def _parse_search_mode(v) -> tuple[SearchMode, str, int, float | None]:
    """Accepts 'Lexical' or {'Vector': {'ann_mode': {'Nprobe': 15}, ...}}.

    Returns (mode, ann_mode, nprobe, similarity_threshold)."""
    if v is None:
        return SearchMode.Lexical, "All", 0, None
    if isinstance(v, str):
        return SearchMode(v), "All", 0, None
    if isinstance(v, dict):
        name = next(iter(v))
        payload = v[name] or {}
        ann = payload.get("ann_mode", "All")
        nprobe = 0
        thr = payload.get("similarity_threshold")
        if isinstance(ann, dict):
            ann_name = next(iter(ann))
            ann_payload = ann[ann_name]
            if ann_name == "Nprobe":
                nprobe = int(ann_payload)
                ann = "Nprobe"
            elif ann_name == "Similaritythreshold":
                thr = float(ann_payload)
                ann = "SimilarityThreshold"
            elif ann_name == "NprobeSimilaritythreshold":
                nprobe = int(ann_payload[0])
                thr = float(ann_payload[1])
                ann = "NprobeSimilarityThreshold"
            else:
                ann = "All"
        elif isinstance(ann, str):
            ann = {"Similaritythreshold": "SimilarityThreshold",
                   "NprobeSimilaritythreshold": "NprobeSimilarityThreshold"
                   }.get(ann, ann)
        return SearchMode(name), ann, nprobe, thr
    return SearchMode.Lexical, "All", 0, None


_RANGES_VARIANTS = {
    "U8", "U16", "U32", "U64", "I8", "I16", "I32", "I64",
    "Timestamp", "F32", "F64", "Point",
}


def _parse_facet(d: dict) -> QueryFacet:
    """Accepts both the reference's externally-tagged Ranges enum wire form
    (reference search.rs:390-420, serde external tagging):
        {"F64": ["CountAboveRange", [["label", 0.0], ...]]}
        {"Point": [rt, [["label", 0.0], ...], [lat, lon], "Kilometers"]}
    and the flattened forms {"ranges": {"ranges": [...]}} / bare list."""
    ranges = None
    r = d.get("ranges")
    if r:
        if isinstance(r, dict):
            variant = next(iter(r))
            if variant in _RANGES_VARIANTS and isinstance(r[variant], (list, tuple)):
                payload = r[variant]
                range_type = str(payload[0])
                buckets = [tuple(x) for x in payload[1]]
                base = unit = None
                if variant == "Point" and len(payload) >= 4:
                    base = tuple(payload[2])
                    unit = str(payload[3])
                ranges = Ranges(
                    field=d["field"], ranges=buckets, range_type=range_type,
                    base=base, unit=unit or "Kilometers",
                )
            else:
                ranges = Ranges(
                    field=d["field"],
                    ranges=[tuple(x) for x in r["ranges"]],
                    range_type=str(r.get("range_type", "CountWithinRange")),
                    base=(tuple(r["base"]) if r.get("base") is not None
                          else None),
                    unit=str(r.get("unit", "Kilometers")),
                )
        else:
            ranges = Ranges(field=d["field"], ranges=[tuple(x) for x in r])
    return QueryFacet(
        field=d["field"], length=d.get("length", 10), ranges=ranges
    )


def _parse_filter(d: dict) -> FacetFilter:
    rng = None
    if "range" in d and d["range"] is not None:
        rng = tuple(d["range"])
    elif "numerical_range" in d and d["numerical_range"] is not None:
        rng = tuple(d["numerical_range"])
    return FacetFilter(field=d["field"], values=d.get("values"), range=rng)


def search_request_from_json(d: dict) -> tuple[SearchRequest, list[DistanceField], bool]:
    """JSON body -> (SearchRequest, distance_fields, enable_empty_query)."""
    mode, ann, nprobe, thr = _parse_search_mode(d.get("search_mode"))
    req = SearchRequest(
        query=d.get("query", ""),
        offset=int(d.get("offset", 0)),
        length=int(d.get("length", 10)),
        result_type=ResultType(d.get("result_type", "TopkCount")),
        realtime=bool(d.get("realtime", False)),
        # API default is Intersection (reference index.rs query_type_api)
        query_type_default=QueryType(d.get("query_type_default", "Intersection")),
        field_filter=list(d.get("field_filter", [])),
        fields=list(d.get("fields", [])),
        highlights=[
            Highlight(
                field=h["field"],
                fragment_number=h.get("fragment_number", 1),
                fragment_size=h.get("fragment_size", 160),
                highlight_markup=h.get("highlight_markup", True),
            )
            for h in d.get("highlights", [])
        ],
        query_facets=[_parse_facet(f) for f in d.get("query_facets", [])],
        facet_filter=[_parse_filter(f) for f in d.get("facet_filter", [])],
        result_sort=[
            ResultSort(
                field=r["field"],
                order=r.get("order", "Descending"),
                base=(r.get("base") if isinstance(r.get("base"), (list, tuple))
                      else None),
            )
            for r in d.get("result_sort", [])
        ],
        search_mode=mode,
        query_vector=d.get("query_vector"),
        ann_mode=ann,
        nprobe=nprobe,
        similarity_threshold=thr,
        query_rewriting=d.get("query_rewriting", "SearchOnly"),
    )
    dfs = [
        DistanceField(
            field=x["field"], distance=x.get("distance", x["field"] + "_distance"),
            base=list(x["base"]), unit=x.get("unit", "Kilometers"),
        )
        for x in d.get("distance_fields", [])
    ]
    return req, dfs, bool(d.get("enable_empty_query", False))


def schema_field_from_api(d: dict):
    """Wire schema field -> SchemaField (reference JSON keys: store,
    index_lexical, index_vector, longest, boost, facet)."""
    from .schema import FieldType, SchemaField

    return SchemaField(
        field=d["field"],
        field_type=FieldType(d.get("field_type", "Text")),
        stored=bool(d.get("store", d.get("stored", False))),
        indexed=bool(d.get("index_lexical", d.get("indexed", False))),
        index_vector=bool(d.get("index_vector", False)),
        facet=bool(d.get("facet", False)),
        boost=float(d.get("boost", 1.0)),
        longest_field=bool(d.get("longest", d.get("longest_field", False))),
        dictionary_source=bool(d.get("dictionary_source", False)),
        completion_source=bool(d.get("completion_source", False)),
    )


def schema_field_to_api(sf) -> dict:
    return {
        "field": sf.field,
        "field_type": sf.field_type.value,
        "store": sf.stored,
        "index_lexical": sf.indexed,
        "index_vector": sf.index_vector,
        "facet": sf.facet,
        "boost": sf.boost,
        "longest": sf.longest_field,
    }


def create_index_request_from_json(d: dict):
    """CreateIndexRequest JSON -> (name, schema, IndexMeta, synonyms)
    (reference index.rs:299-370)."""
    from .schema import (
        ClusteringConfig,
        ClusteringMode,
        DocumentCompression,
        FrequentwordType,
        IndexMeta,
        InferenceType,
        LexicalSimilarity,
        Precision,
        Quantization,
        QueryCompletion,
        SpellingCorrection,
        StemmerType,
        StopwordType,
        TokenizerType,
        VectorConfig,
        VectorSimilarity,
    )

    schema = [schema_field_from_api(f) for f in d.get("schema", [])]
    doc_comp = d.get("document_compression", "Zlib")
    try:
        doc_comp = DocumentCompression(doc_comp)
    except ValueError:
        doc_comp = DocumentCompression.Zlib

    vector = VectorConfig()
    inf = d.get("inference")
    if isinstance(inf, dict) and inf:
        name = next(iter(inf))
        payload = inf[name] or {}
        if name == "External":
            vector = VectorConfig(
                enabled=True,
                dim=int(payload.get("dimensions", 0)),
                similarity=VectorSimilarity(payload.get("similarity", "Cosine")),
                precision=Precision(payload.get("precision", "I8")),
                quantization=Quantization(
                    payload.get("quantization", "ScalarQuantizationI8")
                    if payload.get("quantization") not in (None, "None")
                    else "None"
                ),
                inference=InferenceType.External,
            )
    clustering = d.get("clustering", "Auto")
    if isinstance(clustering, str):
        vector.clustering = ClusteringConfig(mode=ClusteringMode(clustering))
    elif isinstance(clustering, dict):
        name = next(iter(clustering))
        vector.clustering = ClusteringConfig(
            mode=ClusteringMode(name),
            cluster_count=int(clustering[name] or 0),
        )

    meta = IndexMeta(
        name=d.get("index_name", "index"),
        similarity=LexicalSimilarity(d.get("similarity", "Bm25f")),
        tokenizer=TokenizerType(d.get("tokenizer", "UnicodeAlphanumeric")),
        stemmer=StemmerType(d.get("stemmer", "None")),
        stop_words=StopwordType(d.get("stop_words", "None")),
        frequent_words=FrequentwordType(d.get("frequent_words", "None")),
        ngram_indexing=int(d.get("ngram_indexing", 0)),
        doc_compression=doc_comp,
        spelling_correction=SpellingCorrection.from_json(
            d.get("spelling_correction")),
        query_completion=QueryCompletion.from_json(d.get("query_completion")),
        vector=vector,
    )
    return d.get("index_name", "index"), schema, meta, d.get("synonyms", [])


_MILES_PER_KM = 0.621371192


def apply_distance_fields(index, dfs: list[DistanceField], doc_id: int,
                          doc: dict | None) -> dict | None:
    if not dfs:
        return doc
    doc = dict(doc) if doc else {}
    from .facets import get_runtime

    rt = get_runtime(index)
    for df in dfs:
        code = rt.raw_value(df.field, doc_id)
        if code is None:
            # uncommitted tail: read from level0
            sf = index.schema_map.get(df.field)
            shard = index.shards[doc_id % index.shard_count]
            local = doc_id // index.shard_count
            start = 0
            vals = shard.level0.facet_values.get(sf.facet_id, [])
            li = local - shard.full_levels * 65536
            v = vals[li] if 0 <= li < len(vals) else None
            if v is None:
                continue
            import numpy as np

            code = geo.encode_morton_2_d(
                np.array([v[0]]), np.array([v[1]])
            )[0]
        dist = float(geo.point_distance(code, df.base[0], df.base[1]))
        if df.unit == "Miles":
            dist *= _MILES_PER_KM
        doc[df.distance] = dist
    return doc


def result_set_to_json(rs, req: SearchRequest, original_query: str) -> dict:
    return {
        "time": int(rs.time_us * 1000),
        "original_query": original_query,
        "query": original_query,
        "offset": req.offset,
        "length": req.length,
        "count": rs.result_count,
        "count_total": rs.result_count_total,
        "count_exact": bool(rs.count_exact),
        "query_terms": rs.query_terms,
        "results": [
            {"_id": r.doc_id, "_score": r.score, **(r.doc or {})}
            for r in rs.results
        ],
        "facets": {k: [[str(a), b] for a, b in v] for k, v in rs.facets.items()},
        "suggestions": rs.suggestions,
        # vector-search work counters (reference observed_vector_count /
        # observed_cluster_count, search.rs:200-204)
        "observed_vector_count": rs.observed_vector_count,
        "observed_cluster_count": rs.observed_cluster_count,
    }
