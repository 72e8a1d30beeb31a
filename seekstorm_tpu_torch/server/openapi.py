"""OpenAPI 3 description of the REST surface (reference serves
openapi/openapi.json generated by utoipa, api_endpoints.rs:1470-1489)."""

from __future__ import annotations

_SEARCH_REQUEST = {
    "type": "object",
    "properties": {
        "query": {"type": "string"},
        "query_vector": {"type": "array", "items": {"type": "number"}},
        "enable_empty_query": {"type": "boolean", "default": False},
        "offset": {"type": "integer", "default": 0},
        "length": {"type": "integer", "default": 10},
        "result_type": {"type": "string",
                        "enum": ["Count", "Topk", "TopkCount"]},
        "realtime": {"type": "boolean", "default": False},
        "highlights": {"type": "array", "items": {"type": "object"}},
        "field_filter": {"type": "array", "items": {"type": "string"}},
        "fields": {"type": "array", "items": {"type": "string"}},
        "distance_fields": {"type": "array", "items": {"type": "object"}},
        "query_facets": {"type": "array", "items": {"type": "object"}},
        "facet_filter": {"type": "array", "items": {"type": "object"}},
        "result_sort": {"type": "array", "items": {"type": "object"}},
        "query_type_default": {
            "type": "string",
            "enum": ["Union", "Intersection", "Phrase", "Not"],
            "default": "Intersection",
        },
        "query_rewriting": {},
        "search_mode": {},
    },
}

_SEARCH_RESULT = {
    "type": "object",
    "properties": {
        "time": {"type": "integer"},
        "original_query": {"type": "string"},
        "query": {"type": "string"},
        "offset": {"type": "integer"},
        "length": {"type": "integer"},
        "count": {"type": "integer"},
        "count_total": {"type": "integer"},
        "query_terms": {"type": "array", "items": {"type": "string"}},
        "results": {"type": "array", "items": {"type": "object"}},
        "facets": {"type": "object"},
        "suggestions": {"type": "array", "items": {"type": "string"}},
    },
}


def _op(summary, body=None, response=None, params=None):
    op = {"summary": summary,
          "security": [{"apikey": []}],
          "responses": {"200": {"description": "OK"}}}
    if body:
        op["requestBody"] = {"content": {"application/json": {
            "schema": body}}}
    if response:
        op["responses"]["200"] = {
            "description": "OK",
            "content": {"application/json": {"schema": response}},
        }
    if params:
        op["parameters"] = params
    return op


_ID = [{"name": "index_id", "in": "path", "required": True,
        "schema": {"type": "integer"}}]
_DOCID = _ID + [{"name": "doc_id", "in": "path", "required": True,
                 "schema": {"type": "integer"}}]


def openapi_spec() -> dict:
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "seekstorm_tpu server",
            "version": "0.1.0",
            "description": "Multi-tenant TPU-native search server "
                           "(REST surface mirrors the SeekStorm server).",
        },
        "components": {
            "securitySchemes": {
                "apikey": {"type": "apiKey", "in": "header", "name": "apikey"}
            },
            "schemas": {
                "SearchRequest": _SEARCH_REQUEST,
                "SearchResult": _SEARCH_RESULT,
            },
        },
        "paths": {
            "/api/v1/live": {"get": _op("liveness probe")},
            "/api/v1/apikey": {
                "post": _op("create API key (master key)",
                            body={"type": "object"}),
                "delete": _op("delete API key (master key)",
                              body={"type": "object"}),
                "get": _op("list indices of the API key"),
            },
            "/api/v1/index": {
                "post": _op("create index", body={"type": "object"}),
            },
            "/api/v1/index/{index_id}": {
                "get": _op("index info", params=_ID),
                "delete": _op("delete index", params=_ID),
                "patch": _op("commit index", params=_ID),
                "put": _op("close index", params=_ID),
            },
            "/api/v1/index/{index_id}/query": {
                "post": _op("search", params=_ID,
                            body={"$ref": "#/components/schemas/SearchRequest"},
                            response={"$ref":
                                      "#/components/schemas/SearchResult"}),
                "get": _op("search via query params", params=_ID),
            },
            "/api/v2/index/{index_id}/query": {
                "post": _op("binary vector query: raw LE f32 vector in, "
                            "raw LE u64 doc ids out", params=_ID),
            },
            "/api/v1/index/{index_id}/doc": {
                "post": _op("index document(s)", params=_ID,
                            body={"type": "object"}),
                "patch": _op("update document(s)", params=_ID,
                             body={"type": "array", "items": {}}),
                "delete": _op("delete documents by ids or query", params=_ID),
            },
            "/api/v1/index/{index_id}/doc/{doc_id}": {
                "get": _op("get document", params=_DOCID),
                "delete": _op("delete document", params=_DOCID),
            },
            "/api/v1/index/{index_id}/file": {
                "post": _op("index a PDF file (raw bytes body)", params=_ID),
            },
            "/api/v1/index/{index_id}/synonyms": {
                "get": _op("get synonyms", params=_ID),
                "put": _op("set synonyms", params=_ID,
                           body={"type": "array", "items": {}}),
                "post": _op("add synonyms", params=_ID,
                            body={"type": "array", "items": {}}),
            },
            "/api/v1/index/{index_id}/iterator": {
                "post": _op("iterate doc ids", params=_ID,
                            body={"type": "object"}),
                "get": _op("iterate doc ids via query params", params=_ID),
            },
        },
    }
