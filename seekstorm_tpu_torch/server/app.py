"""HTTP server: REST API v1 (JSON) + v2 (binary vector query).

Route table mirrors the reference server (reference seekstorm_server/src/
http_server.rs:176-1478 http_request_handler match arms; handlers
api_endpoints.rs).  Implemented with the stdlib ThreadingHTTPServer — the
data plane is on the server's torch device, the HTTP layer is orchestration.

v2 binary endpoint (reference http_server.rs:218-288): the reference uses
rkyv-archived Vec<f32> in / Vec<u64> out; this server uses raw
little-endian f32 bytes in / raw little-endian u64 doc ids out with the
same fixed Nprobe(15)/top-10 behavior.

The port's copy of ``seekstorm_tpu/server/app.py``.  What differs: a server
is bound to one torch device (``SearchServer(..., device="cuda")``), resolved
once when it starts, so a server asked for CUDA on a host without a card
raises instead of serving from the CPU; every index it creates or opens and
every search it runs (queries, the v2 binary query, delete by query) is on
that device.  /metrics renders the port's METRICS, whose
``k1_launches_total`` ... ``k6_launches_total`` count the hand-written
kernels' launches, and /trace drives the port's torch.profiler hooks
from any request thread (its trace holds the program's timer spans).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..api_types import (
    apply_distance_fields,
    create_index_request_from_json,
    result_set_to_json,
    schema_field_to_api,
    search_request_from_json,
)
from ..index import create_index
from ..search import (
    ResultSet,
    ResultType,
    SearchMode,
    SearchRequest,
    resolve_device,
    search as run_search,
)
from .tenancy import (
    ApikeyObject,
    ApikeyQuota,
    RateLimiter,
    generate_apikey,
    hash_apikey,
    load_apikeys,
    master_apikey,
)

DEFAULT_MASTER_SECRET = "master_key_secret"


class SearchServer:
    def __init__(self, index_path, host="127.0.0.1", port=80, device="cuda"):
        # first, so that a device this host lacks fails before any state
        self.device = resolve_device(device)
        self.root = Path(index_path)
        self.root.mkdir(parents=True, exist_ok=True)
        self.host = host
        self.port = port
        secret = os.environ.get("MASTER_KEY_SECRET", DEFAULT_MASTER_SECRET)
        if secret == DEFAULT_MASTER_SECRET and host not in (
            "127.0.0.1", "localhost", "::1",
        ):
            import sys

            print(
                "WARNING: MASTER_KEY_SECRET is unset — the master API key is "
                "predictable. Set MASTER_KEY_SECRET before binding "
                f"non-loopback addresses ({host}).",
                file=sys.stderr,
            )
        self.master_key = master_apikey(secret)
        self.master_hash = hash_apikey(self.master_key)
        self.apikeys = load_apikeys(self.root, self.device)
        self.rate = RateLimiter()
        self.lock = threading.RLock()
        self.httpd = None

    # ------------------------------------------------------------------
    def serve_forever(self):
        server = self

        class Handler(_Handler):
            ctx = server

        self.httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self.httpd.server_address[1]
        self.httpd.serve_forever()

    def shutdown(self):
        if self.httpd:
            self.httpd.shutdown()
        with self.lock:
            for ak in self.apikeys.values():
                for ix in ak.index_list.values():
                    ix.commit()

    # ------------------------------------------------------------------
    def auth(self, headers) -> ApikeyObject | None:
        key = headers.get("apikey")
        if not key:
            return None
        try:
            h = hash_apikey(key)
        except Exception:
            return None
        return self.apikeys.get(h)

    def is_master(self, headers) -> bool:
        import hmac

        key = headers.get("apikey")
        # constant-time compare (timing side channel hardening)
        return bool(key) and hmac.compare_digest(key, self.master_key)


class _Handler(BaseHTTPRequestHandler):
    ctx: SearchServer = None  # type: ignore
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet
        pass

    # -- helpers -------------------------------------------------------
    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _json(self):
        raw = self._body()
        if not raw:
            return {}
        return json.loads(raw)

    def _send(self, code: int, payload, binary=False):
        if binary:
            data = payload
            ctype = "application/octet-stream"
        else:
            data = json.dumps(payload).encode()
            ctype = "application/json"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(data)

    def _err(self, code: int, msg: str):
        self._send(code, {"error": msg})

    # -- dispatch ------------------------------------------------------
    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")

    def do_PATCH(self):
        self._route("PATCH")

    def do_PUT(self):
        self._route("PUT")

    def do_OPTIONS(self):
        self.send_response(204)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "*")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _route(self, method: str):
        try:
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            q = parse_qs(url.query)
            self._route2(method, parts, q)
        except BrokenPipeError:
            pass
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            try:
                self._err(400, f"bad request: {type(e).__name__}: {e}")
            except Exception:
                pass
        except Exception as e:  # pragma: no cover
            traceback.print_exc()
            try:
                self._err(500, f"{type(e).__name__}: {e}")
            except Exception:
                pass

    def _route2(self, method, parts, q):
        ctx = self.ctx
        if not parts and method == "GET":
            from .webui import INDEX_HTML

            data = INDEX_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if parts == ["openapi.json"] and method == "GET":
            from .openapi import openapi_spec

            return self._send(200, openapi_spec())
        if parts == ["metrics"] and method == "GET":
            # Prometheus text format (observability surface, metrics.py)
            from ..metrics import METRICS

            data = METRICS.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if len(parts) == 2 and parts[0] == "trace" and method == "POST":
            # device tracing: POST /trace/start {"log_dir": ...} | /trace/stop
            from ..metrics import start_trace, stop_trace

            if not self.ctx.is_master(self.headers):
                return self._err(401, "master apikey required")
            if parts[1] == "start":
                body = self._json() or {}
                r = start_trace(body.get("log_dir", "/tmp/seekstorm_trace"))
                if isinstance(r, str):
                    return self._send(503, {"tracing": False, "error": r})
                return self._send(200, {"tracing": bool(r)})
            if parts[1] == "stop":
                r = stop_trace()
                if isinstance(r, str):
                    return self._send(503, {"stopped": False, "error": r})
                return self._send(200, {"stopped": bool(r)})
        if len(parts) >= 2 and parts[0] == "api":
            ver, rest = parts[1], parts[2:]
        else:
            return self._err(404, "not found")

        # GET /api/v1/live
        if ver == "v1" and rest == ["live"] and method == "GET":
            return self._send(200, {"status": "ok"})

        # ---- apikey management (master key) ----
        if ver == "v1" and rest == ["apikey"]:
            if method == "POST":
                if not ctx.is_master(self.headers):
                    return self._err(401, "master apikey required")
                quota = ApikeyQuota.from_json(self._json() or {})
                key = generate_apikey()
                ak = ApikeyObject(apikey_hash=hash_apikey(key), quota=quota)
                with ctx.lock:
                    ctx.apikeys[ak.apikey_hash] = ak
                    ak.save(ctx.root)
                return self._send(200, {"apikey": key})
            if method == "DELETE":
                if not ctx.is_master(self.headers):
                    return self._err(401, "master apikey required")
                body = self._json()
                h = hash_apikey(body["apikey_base64"])
                with ctx.lock:
                    ak = ctx.apikeys.pop(h, None)
                    if ak is None:
                        return self._err(404, "unknown apikey")
                    for ix in ak.index_list.values():
                        ix.delete_index()
                    import shutil

                    shutil.rmtree(ctx.root / h, ignore_errors=True)
                return self._send(200, {"deleted": True})
            if method == "GET":
                ak = ctx.auth(self.headers)
                if ak is None:
                    return self._err(401, "invalid apikey")
                return self._send(
                    200,
                    {
                        str(iid): {
                            "name": ix.meta.name,
                            "indexed_doc_count": ix.indexed_doc_count,
                        }
                        for iid, ix in ak.index_list.items()
                    },
                )
            return self._err(405, "method not allowed")

        ak = ctx.auth(self.headers)
        if ak is None:
            return self._err(401, "invalid apikey")
        if not ctx.rate.allow(ak.apikey_hash, ak.quota.rate_limit):
            return self._err(429, "rate limit exceeded")

        if ver == "v2" and len(rest) == 3 and rest[0] == "index" and \
                rest[2] == "query" and method == "POST":
            return self._v2_query(ak, int(rest[1]))

        if ver != "v1" or not rest or rest[0] != "index":
            return self._err(404, "not found")

        # POST /api/v1/index — create
        if len(rest) == 1 and method == "POST":
            body = self._json()
            name, schema, meta, synonyms = create_index_request_from_json(body)
            with ctx.lock:
                if len(ak.index_list) >= ak.quota.indices_max:
                    return self._err(403, "indices_max quota exceeded")
                iid = max(ak.index_list.keys(), default=-1) + 1
                meta.id = iid
                ix = create_index(
                    ctx.root / ak.apikey_hash / str(iid), schema, meta=meta,
                    shard_count=int(body.get("shard_number", 0) or 1),
                    device=ctx.device,
                )
                if synonyms:
                    ix.set_synonyms(synonyms)
                ak.index_list[iid] = ix
            return self._send(200, {"id": iid})

        if len(rest) < 2:
            return self._err(404, "not found")
        iid = int(rest[1])
        ix = ak.index_list.get(iid)
        if ix is None:
            return self._err(404, f"unknown index {iid}")
        sub = rest[2] if len(rest) > 2 else ""

        if sub == "":
            if method == "DELETE":
                with ctx.lock:
                    ix.delete_index()
                    del ak.index_list[iid]
                return self._send(200, {"deleted": True})
            if method == "PATCH":   # commit (reference http_server.rs:564)
                ix.commit()
                return self._send(200, {"committed": True})
            if method == "PUT":     # close (reference http_server.rs:603)
                ix.close()
                return self._send(200, {"closed": True})
            if method == "GET":     # info
                info = ix.info()
                info["schema"] = [schema_field_to_api(sf) for sf in ix.schema]
                # numeric-facet min/max (reference index_facets_minmax,
                # index.rs:4649) — feeds the web UI's range sliders
                minmax = {}
                from ..facets import index_facets_minmax

                for sf in ix.facet_fields:
                    if sf.field_type.is_numeric:
                        lo, hi = index_facets_minmax(ix, sf.field)
                        if lo is not None:
                            minmax[sf.field] = [float(lo), float(hi)]
                if minmax:
                    info["facets_minmax"] = minmax
                return self._send(200, info)
            return self._err(405, "method not allowed")

        if sub == "query":
            if method == "POST":
                body = self._json()
            else:
                body = {k: v[0] for k, v in q.items()}
                for key in ("offset", "length"):
                    if key in body:
                        body[key] = int(body[key])
                if "realtime" in body:
                    body["realtime"] = body["realtime"] in ("true", "1", "True")
            return self._query(ak, ix, body)

        if sub == "doc":
            return self._doc(ak, ix, method, rest[3:], q)

        if sub == "synonyms":
            if method == "GET":
                return self._send(200, ix.synonyms)
            if method in ("POST", "PUT"):
                body = self._json()
                with ctx.lock:
                    if method == "PUT":
                        ix.set_synonyms(body)
                    else:
                        ix.add_synonyms(body)
                return self._send(200, {"count": len(ix.synonyms)})
            return self._err(405, "method not allowed")

        if sub == "file":
            if method == "POST":
                # PDF upload -> index (reference index_file_api
                # api_endpoints.rs; extractor is in-repo, pdftext.py)
                raw = self._body()
                from ..pdftext import extract_text

                try:
                    text, meta = extract_text(raw)
                except Exception as e:
                    return self._err(400, f"PDF parse failed: {e}")
                title = meta.get("title") or "document.pdf"
                doc = {"title": title, "body": text}
                if meta.get("creation_date"):
                    doc["date"] = meta["creation_date"]
                with ctx.lock:
                    did = ix.index_document(doc)
                return self._send(200, did)
            return self._err(405, "method not allowed")

        if sub == "iterator":
            body = self._json() if method == "POST" else {
                k: v[0] for k, v in q.items()
            }
            res = ix.get_iterator(
                document_id=body.get("document_id"),
                skip=int(body.get("skip", 0)),
                take=int(body.get("take", 1)),
                include_deleted=bool(body.get("include_deleted", False)),
                include_document=bool(body.get("include_document", False)),
                fields=body.get("fields") or [],
            )
            if body.get("include_document"):
                return self._send(
                    200,
                    [{"_id": g, "doc": doc} for g, doc in res],
                )
            return self._send(200, res)

        return self._err(404, "not found")

    # ------------------------------------------------------------------
    def _query(self, ak: ApikeyObject, ix, body: dict):
        req, dfs, enable_empty = search_request_from_json(body)
        if not req.query.strip() and not enable_empty and \
                req.search_mode == SearchMode.Lexical:
            rs_json = result_set_to_json(ResultSet(), req,
                                         body.get("query", ""))
            return self._send(200, rs_json)
        rs = run_search(ix, req, self.ctx.device)
        if dfs:
            for r in rs.results:
                doc = r.doc if r.doc is not None else (ix.get_document(r.doc_id)
                                                       if req.fields else {})
                r.doc = apply_distance_fields(ix, dfs, r.doc_id, doc)
        ak.operations_count += 1
        return self._send(200, result_set_to_json(rs, req, body.get("query", "")))

    def _doc(self, ak: ApikeyObject, ix, method, tail, q):
        ctx = self.ctx
        if method == "POST":
            body = self._json()
            docs = body if isinstance(body, list) else [body]
            with ctx.lock:
                total = sum(i.indexed_doc_count for i in ak.index_list.values())
                if total + len(docs) > ak.quota.documents_max:
                    return self._err(403, "documents_max quota exceeded")
                ids = ix.index_documents(docs)
            ak.operations_count += len(docs)
            return self._send(200, ids if len(ids) > 1 else ids[0])
        if method == "GET":
            if not tail:
                return self._err(400, "doc id required")
            doc_id = int(tail[0])
            body = {}
            doc = ix.get_document(doc_id)
            if doc is None:
                return self._err(404, "unknown doc")
            return self._send(200, doc)
        if method == "PATCH":
            body = self._json()
            pairs = body if isinstance(body[0], list) else [body]
            with ctx.lock:
                new_ids = ix.update_documents(
                    [(int(p[0]), p[1]) for p in pairs]
                )
            return self._send(200, new_ids if len(new_ids) > 1 else new_ids[0])
        if method == "DELETE":
            raw = self._body()
            body = json.loads(raw) if raw else None
            with ctx.lock:
                if body is None and tail:
                    ix.delete_document(int(tail[0]))
                    n = 1
                elif isinstance(body, list):
                    ix.delete_documents([int(x) for x in body])
                    n = len(body)
                elif isinstance(body, int):
                    ix.delete_document(body)
                    n = 1
                elif isinstance(body, dict) and "query" in body:
                    # delete by query (reference DeleteDocumentsByQuery)
                    req, _, _ = search_request_from_json(
                        {**body, "length": 100_000, "result_type": "Topk"}
                    )
                    rs = run_search(ix, req, ctx.device)
                    ids = [r.doc_id for r in rs.results]
                    ix.delete_documents(ids)
                    n = len(ids)
                else:
                    return self._err(400, "bad delete request")
            return self._send(200, {"deleted": n})
        return self._err(405, "method not allowed")

    def _v2_query(self, ak: ApikeyObject, iid: int):
        """Binary endpoint: raw LE f32 vector -> raw LE u64 doc ids
        (fixed Nprobe(15)/top-10, reference http_server.rs:218-288)."""
        ix = ak.index_list.get(iid)
        if ix is None:
            return self._err(404, f"unknown index {iid}")
        raw = self._body()
        vec = np.frombuffer(raw, dtype="<f4")
        req = SearchRequest(
            search_mode=SearchMode.Vector,
            query_vector=vec.tolist(),
            length=10,
            ann_mode="Nprobe",
            nprobe=15,
            result_type=ResultType.Topk,
        )
        rs = run_search(ix, req, self.ctx.device)
        out = np.array([r.doc_id for r in rs.results], dtype="<u8").tobytes()
        return self._send(200, out, binary=True)


def start_server(index_path, host="127.0.0.1", port=80,
                 device="cuda") -> SearchServer:
    srv = SearchServer(index_path, host, port, device)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    import time

    for _ in range(100):
        if srv.httpd is not None:
            break
        time.sleep(0.05)
    return srv
