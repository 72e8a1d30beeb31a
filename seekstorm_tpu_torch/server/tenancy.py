"""Multi-tenancy: API keys, quotas, rate limiting.

Mirrors the reference's tenancy layer (reference seekstorm_server/src/
multi_tenancy.rs:8-25 apikey->hash lookup, seekstorm/src/index.rs:258-297
ApikeyQuotaObject/ApikeyObject, server.rs:143-146 master key from
MASTER_KEY_SECRET, http_server.rs:144 sliding-window rate limit).

Directory layout per key (reference ARCHITECTURE.md:84-105):
    <index_path>/<apikey_hash>/apikey.json
    <index_path>/<apikey_hash>/<index_id>/...

The port's copy of ``seekstorm_tpu/server/tenancy.py``.  What differs:
``load_apikeys(root, device)`` opens every index on the server's device; an
index that fails to open because of the device (a CUDA error, out of device
memory) raises, so a fault of the card never turns into a missing index, and
any other failure skips the index, as the reference does, with the directory
and the exception named on stderr.
"""

from __future__ import annotations

import base64
import hashlib
import json
import secrets
import sys
import threading
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path


@dataclass
class ApikeyQuota:
    """(reference ApikeyQuotaObject index.rs:258-282)"""

    indices_max: int = 10
    indices_size_max: int = 100_000
    documents_max: int = 10_000_000
    operations_max: int = 100_000_000
    rate_limit: int | None = None

    @staticmethod
    def from_json(d: dict) -> "ApikeyQuota":
        return ApikeyQuota(
            indices_max=d.get("indices_max", 10),
            indices_size_max=d.get("indices_size_max", 100_000),
            documents_max=d.get("documents_max", 10_000_000),
            operations_max=d.get("operations_max", 100_000_000),
            rate_limit=d.get("rate_limit"),
        )


def hash_apikey(apikey_base64: str) -> str:
    """base64 apikey -> hex hash (directory name / lookup key)."""
    raw = base64.b64decode(apikey_base64)
    return hashlib.sha256(raw).hexdigest()


def master_apikey(secret: str) -> str:
    """MASTER_KEY_SECRET -> base64 master API key (reference server.rs:134)."""
    return base64.b64encode(hashlib.sha256(secret.encode()).digest()).decode()


class RateLimiter:
    """Per-key sliding-window QPS limit (reference http_server.rs:144)."""

    def __init__(self):
        self._hits: dict[str, list[float]] = {}
        self._lock = threading.Lock()

    def allow(self, key: str, limit: int | None) -> bool:
        if not limit:
            return True
        now = time.monotonic()
        with self._lock:
            hits = self._hits.setdefault(key, [])
            while hits and now - hits[0] > 1.0:
                hits.pop(0)
            if len(hits) >= limit:
                return False
            hits.append(now)
            return True


@dataclass
class ApikeyObject:
    """(reference ApikeyObject index.rs:284-297)"""

    apikey_hash: str
    quota: ApikeyQuota
    index_list: dict = field(default_factory=dict)  # index_id -> Index
    operations_count: int = 0

    @property
    def dir_name(self) -> str:
        return self.apikey_hash

    def save(self, root: Path) -> None:
        d = root / self.apikey_hash
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / "apikey.json.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"apikey_hash": self.apikey_hash, "quota": asdict(self.quota),
                 "operations_count": self.operations_count},
                f,
            )
        tmp.replace(d / "apikey.json")  # atomic (reference api_endpoints.rs:38)


def generate_apikey() -> str:
    return base64.b64encode(secrets.token_bytes(32)).decode()


def _device_failure(e: BaseException) -> bool:
    """Whether an exception comes from the torch device: torch's own errors
    (CUDA, out of device memory, an accelerator fault) are RuntimeErrors
    defined in torch or naming CUDA."""
    if not isinstance(e, RuntimeError):
        return False
    return (type(e).__module__.split(".")[0] == "torch"
            or "cuda" in str(e).lower())


def load_apikeys(root: Path, device="cuda") -> dict[str, ApikeyObject]:
    """Walk the index root, load API keys + open their indices on `device`
    (reference open_all_apikeys api_endpoints.rs:223)."""
    from ..index import open_index

    out: dict[str, ApikeyObject] = {}
    if not root.exists():
        return out
    for d in sorted(root.iterdir()):
        meta = d / "apikey.json"
        if not d.is_dir() or not meta.exists():
            continue
        with open(meta) as f:
            j = json.load(f)
        ak = ApikeyObject(
            apikey_hash=j["apikey_hash"],
            quota=ApikeyQuota.from_json(j.get("quota", {})),
            operations_count=j.get("operations_count", 0),
        )
        for ix_dir in sorted(d.iterdir()):
            if ix_dir.is_dir() and (ix_dir / "index.json").exists():
                try:
                    ak.index_list[int(ix_dir.name)] = open_index(
                        ix_dir, device=device)
                except Exception as e:
                    if _device_failure(e):
                        raise
                    print(f"skipping index {ix_dir}: {type(e).__name__}: "
                          f"{e}", file=sys.stderr)
                    continue
        out[ak.apikey_hash] = ak
    return out
