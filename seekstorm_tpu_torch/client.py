"""REST client SDK (reference seekstorm_client/src/api_endpoints.rs:13-1084
RestClient — one method per endpoint), stdlib urllib, no dependencies."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np


class RestClient:
    def __init__(self, base_url: str, apikey: str = ""):
        self.base = base_url.rstrip("/")
        self.apikey = apikey

    # ------------------------------------------------------------------
    def _call(self, method: str, path: str, body=None, binary=False,
              apikey: str | None = None):
        url = f"{self.base}{path}"
        if binary and isinstance(body, (bytes, bytearray)):
            data = bytes(body)
            ctype = "application/octet-stream"
        else:
            data = json.dumps(body).encode() if body is not None else None
            ctype = "application/json"
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("apikey", apikey if apikey is not None else self.apikey)
        if data is not None:
            req.add_header("Content-Type", ctype)
        try:
            with urllib.request.urlopen(req) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            raise RestError(e.code, e.read().decode(errors="replace")) from None
        if binary:
            return raw
        return json.loads(raw) if raw else None

    # ------------------------------------------------------------------
    def live(self):
        return self._call("GET", "/api/v1/live")

    def create_apikey(self, quota: dict | None = None, master_key: str = ""):
        r = self._call("POST", "/api/v1/apikey", quota or {},
                       apikey=master_key)
        return r["apikey"]

    def delete_apikey(self, apikey_base64: str, master_key: str = ""):
        return self._call("DELETE", "/api/v1/apikey",
                          {"apikey_base64": apikey_base64}, apikey=master_key)

    def get_apikey_indices(self):
        return self._call("GET", "/api/v1/apikey")

    def create_index(self, request: dict) -> int:
        return self._call("POST", "/api/v1/index", request)["id"]

    def get_index_info(self, index_id: int):
        return self._call("GET", f"/api/v1/index/{index_id}")

    def delete_index(self, index_id: int):
        return self._call("DELETE", f"/api/v1/index/{index_id}")

    def commit_index(self, index_id: int):
        return self._call("PATCH", f"/api/v1/index/{index_id}")

    def close_index(self, index_id: int):
        return self._call("PUT", f"/api/v1/index/{index_id}")

    def index_document(self, index_id: int, doc: dict):
        return self._call("POST", f"/api/v1/index/{index_id}/doc", doc)

    def index_documents(self, index_id: int, docs: list):
        return self._call("POST", f"/api/v1/index/{index_id}/doc", docs)

    def index_pdf_bytes(self, index_id: int, data: bytes):
        """Upload a PDF; the server extracts text + title/date and indexes
        it (reference RestClient index_pdf_file, api_endpoints.rs)."""
        raw = self._call("POST", f"/api/v1/index/{index_id}/file",
                         body=bytes(data), binary=True)
        return json.loads(raw) if raw else None

    def index_pdf_file(self, index_id: int, path):
        with open(path, "rb") as f:
            return self.index_pdf_bytes(index_id, f.read())

    def get_document(self, index_id: int, doc_id: int):
        return self._call("GET", f"/api/v1/index/{index_id}/doc/{doc_id}")

    def update_document(self, index_id: int, doc_id: int, doc: dict):
        return self._call("PATCH", f"/api/v1/index/{index_id}/doc",
                          [doc_id, doc])

    def delete_document(self, index_id: int, doc_id: int):
        return self._call("DELETE", f"/api/v1/index/{index_id}/doc/{doc_id}")

    def delete_documents(self, index_id: int, doc_ids: list):
        return self._call("DELETE", f"/api/v1/index/{index_id}/doc", doc_ids)

    def delete_documents_by_query(self, index_id: int, query: dict):
        return self._call("DELETE", f"/api/v1/index/{index_id}/doc", query)

    def query(self, index_id: int, request: dict):
        return self._call("POST", f"/api/v1/index/{index_id}/query", request)

    def query_get(self, index_id: int, query: str, offset=0, length=10):
        from urllib.parse import quote

        return self._call(
            "GET",
            f"/api/v1/index/{index_id}/query?query={quote(query)}"
            f"&offset={offset}&length={length}",
        )

    def query_binary(self, index_id: int, vector) -> list[int]:
        """v2 binary endpoint: raw f32 vector in, doc-id list out."""
        raw = np.asarray(vector, dtype="<f4").tobytes()
        out = self._call("POST", f"/api/v2/index/{index_id}/query", raw,
                         binary=True)
        return np.frombuffer(out, dtype="<u8").tolist()

    def get_synonyms(self, index_id: int):
        return self._call("GET", f"/api/v1/index/{index_id}/synonyms")

    def set_synonyms(self, index_id: int, synonyms: list):
        return self._call("PUT", f"/api/v1/index/{index_id}/synonyms", synonyms)

    def add_synonyms(self, index_id: int, synonyms: list):
        return self._call("POST", f"/api/v1/index/{index_id}/synonyms",
                          synonyms)

    def get_iterator(self, index_id: int, **kwargs):
        return self._call("POST", f"/api/v1/index/{index_id}/iterator", kwargs)


class RestError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body
