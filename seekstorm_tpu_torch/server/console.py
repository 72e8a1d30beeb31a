"""Interactive server console (reference seekstorm_server/src/server.rs:425-1120
console command loop: ingest / search / delete / quit / help, plus the
searchsift recall harness server.rs:455-720).

The port's copy of ``seekstorm_tpu/server/console.py``.  What differs: the
commands create and search indexes on the server's device
(``server.device``).
"""

from __future__ import annotations

import shlex
import sys
import time


HELP = """commands:
  help                          show this help
  quit / exit                   commit all indices and stop the server
  list                          list API keys and indices
  create <name>                 create a demo index under the master demo key
  ingest <path> [index_id]      ingest a local file (ndjson/json/csv) into an index
  ingestsift <dir> [index_id]   build a SIFT vector index from fvecs files
  info <index_id>               show index statistics
  search <index_id> <query...>  run a lexical search
  searchsift <dir> <index_id> [nprobe]   recall@10 harness against SIFT ground truth
  delete <index_id>             delete an index
"""


def run_console(server, demo_apikey_hash: str | None = None) -> None:
    print("seekstorm_tpu server console — type 'help'")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            line = "quit"
        if not line:
            continue
        try:
            if not handle_command(server, line, demo_apikey_hash):
                break
        except Exception as e:
            print(f"error: {type(e).__name__}: {e}")


def _first_apikey(server):
    for ak in server.apikeys.values():
        return ak
    # bootstrap a console key under the master hash
    from .tenancy import ApikeyObject, ApikeyQuota

    ak = ApikeyObject(apikey_hash=server.master_hash, quota=ApikeyQuota())
    server.apikeys[ak.apikey_hash] = ak
    ak.save(server.root)
    return ak


def handle_command(server, line: str, demo_hash=None) -> bool:
    """Returns False when the server should stop."""
    parts = shlex.split(line)
    cmd, args = parts[0].lower(), parts[1:]
    if cmd in ("quit", "exit"):
        print("committing and shutting down…")
        server.shutdown()
        return False
    if cmd == "help":
        print(HELP)
        return True
    if cmd == "list":
        for h, ak in server.apikeys.items():
            print(f"apikey {h[:12]}…  indices={list(ak.index_list)}")
        return True
    if cmd == "create":
        from ..api_types import create_index_request_from_json
        from ..index import create_index
        from .tenancy import ApikeyObject, ApikeyQuota, hash_apikey

        ak = _first_apikey(server)
        if ak is None:
            ak = ApikeyObject(apikey_hash=server.master_hash,
                              quota=ApikeyQuota())
            server.apikeys[ak.apikey_hash] = ak
            ak.save(server.root)
        name = args[0] if args else "demo"
        _, schema, meta, _ = create_index_request_from_json({
            "index_name": name,
            "schema": [
                {"field": "title", "field_type": "Text", "store": True,
                 "index_lexical": True, "boost": 10.0},
                {"field": "body", "field_type": "Text", "store": True,
                 "index_lexical": True},
            ],
        })
        iid = max(ak.index_list.keys(), default=-1) + 1
        meta.id = iid
        ix = create_index(server.root / ak.apikey_hash / str(iid), schema,
                          meta=meta, shard_count=1, device=server.device)
        ak.index_list[iid] = ix
        print(f"created index {iid} ({name})")
        return True
    if cmd == "ingest":
        from ..ingest import ingest_file

        ak = _first_apikey(server)
        iid = int(args[1]) if len(args) > 1 else next(iter(ak.index_list))
        ix = ak.index_list[iid]
        t0 = time.time()
        n = ingest_file(ix, args[0])
        ix.commit()
        dt = time.time() - t0
        print(f"ingested {n} docs in {dt:.1f}s ({n/max(dt,1e-9):.0f} docs/s)")
        return True
    if cmd == "ingestsift":
        from ..ingest import ingest_sift

        ak = _first_apikey(server)
        iid = int(args[1]) if len(args) > 1 else None
        ix, n = ingest_sift(server, ak, args[0], iid)
        print(f"ingested {n} SIFT vectors into index {ix.meta.id}")
        return True
    if cmd == "searchsift":
        from ..ingest import search_sift

        ak = _first_apikey(server)
        iid = int(args[1])
        nprobe = int(args[2]) if len(args) > 2 else 16
        recall, lat_us = search_sift(ak.index_list[iid], args[0], nprobe)
        print(f"recall@10={recall*100:.2f}%  avg={lat_us:.0f}µs  nprobe={nprobe}")
        return True
    if cmd == "info":
        import json as _json

        ak = _first_apikey(server)
        iid = int(args[0])
        print(_json.dumps(ak.index_list[iid].info(), indent=1))
        return True
    if cmd == "search":
        from ..search import SearchRequest, search

        ak = _first_apikey(server)
        iid = int(args[0])
        query = " ".join(args[1:])
        ix = ak.index_list[iid]
        t0 = time.time()
        rs = search(ix, SearchRequest(query=query), server.device)
        dt = (time.time() - t0) * 1e6
        print(f"{rs.result_count_total} results in {dt:.0f}µs")
        for r in rs.results:
            print(f"  {r.doc_id}  {r.score:.4f}")
        return True
    if cmd == "delete":
        ak = _first_apikey(server)
        iid = int(args[0])
        ix = ak.index_list.pop(iid)
        ix.delete_index()
        print(f"deleted index {iid}")
        return True
    print(f"unknown command {cmd!r} — type 'help'")
    return True
