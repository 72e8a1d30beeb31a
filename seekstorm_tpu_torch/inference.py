"""Embedding inference: Model2Vec static-embedding models + text chunking.

Mirrors the reference's inference layer (reference seekstorm/src/
vector.rs:284-318 Inference::{Model2Vec, Model2VecCustom, External},
:561-576 sentence-boundary chunking).  Model2Vec models are static token
embeddings mean-pooled over the tokenized input — inference is a gather +
mean, which runs fine host-side (numpy) and batches trivially.

The reference ships 7 predefined Potion models downloaded at runtime; this
environment has no network egress, so the predefined names raise a clear
error pointing at Model2VecCustom with a local model directory containing:
    model.safetensors (or embeddings.npy)  — [vocab, dim] float matrix
    tokenizer.json                          — HuggingFace tokenizers file
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

PREDEFINED_MODELS = {
    "minishlab/potion-base-2M",
    "minishlab/potion-base-4M",
    "minishlab/potion-base-8M",
    "minishlab/potion-base-32M",
    "minishlab/potion-retrieval-32M",
    "minishlab/potion-multilingual-128M",
    "minishlab/M2V_base_output",
}


def _resolve_predefined(name: str) -> Path | None:
    """Local-cache resolution for a predefined model name: checks
    $SEEKSTORM_TPU_MODEL_DIR/<org>--<model>, then HuggingFace hub caches
    (models--<org>--<model>/snapshots/*)."""
    import os

    flat = name.replace("/", "--")
    roots = []
    env = os.environ.get("SEEKSTORM_TPU_MODEL_DIR")
    if env:
        roots.append(Path(env))
    hf = os.environ.get("HF_HOME")
    if hf:
        roots.append(Path(hf) / "hub")
    roots.append(Path.home() / ".cache" / "huggingface" / "hub")
    for root in roots:
        direct = root / flat
        if direct.is_dir():
            return direct
        snaps = root / f"models--{flat}" / "snapshots"
        if snaps.is_dir():
            for snap in sorted(snaps.iterdir(), reverse=True):
                if snap.is_dir():
                    return snap
    return None


# texts a gather in Model2Vec.encode: [block, tokens, dim] float32 at once
_ENCODE_BLOCK = 4096


class Model2Vec:
    """Static-embedding model: tokenize -> gather -> mean-pool."""

    def __init__(self, embeddings: np.ndarray, tokenizer):
        self.embeddings = np.asarray(embeddings, dtype=np.float32)
        self.tokenizer = tokenizer
        self.dim = self.embeddings.shape[1]

    @classmethod
    def load(cls, model_dir: str | Path) -> "Model2Vec":
        p = Path(model_dir)
        if not p.exists() and str(model_dir) in PREDEFINED_MODELS:
            # predefined names resolve from local caches (pre-downloaded
            # HF snapshots or SEEKSTORM_TPU_MODEL_DIR) before erroring —
            # the reference downloads them at runtime; this environment
            # has no egress
            cached = _resolve_predefined(str(model_dir))
            if cached is not None:
                p = cached
            else:
                raise RuntimeError(
                    f"predefined Model2Vec model {model_dir!r} requires a "
                    "network download, which this environment does not "
                    "allow; download it elsewhere into "
                    "$SEEKSTORM_TPU_MODEL_DIR/<org>--<name> (or an HF "
                    "cache) or pass a local directory via "
                    "Inference Model2VecCustom"
                )
        if not p.exists():
            raise FileNotFoundError(f"model directory {model_dir} not found")
        emb = None
        if (p / "embeddings.npy").exists():
            emb = np.load(p / "embeddings.npy")
        elif (p / "model.safetensors").exists():
            emb = _load_safetensors_matrix(p / "model.safetensors")
        else:
            raise FileNotFoundError(
                f"{p}: need embeddings.npy or model.safetensors"
            )
        tok = _load_tokenizer(p)
        return cls(emb, tok)

    def encode(self, texts: list[str]) -> np.ndarray:
        """Mean-pooled embeddings [n, dim], bit for bit each text's
        ``embeddings[ids].mean(axis=0)``: texts of one token count are
        gathered together, ``_ENCODE_BLOCK`` at a time, and summed over
        their tokens in order (the sequential float32 sum of that mean)."""
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        by_len: dict[int, list[int]] = {}
        ids = []
        for i, t in enumerate(texts):
            a = self._token_ids(t)
            a = a[a < len(self.embeddings)]
            ids.append(a)
            if len(a):
                by_len.setdefault(len(a), []).append(i)
        for n, rows in by_len.items():
            for b in range(0, len(rows), _ENCODE_BLOCK):
                r = rows[b:b + _ENCODE_BLOCK]
                x = self.embeddings[np.stack([ids[i] for i in r])]
                out[r] = np.add.reduce(x, axis=1) / n
        return out

    def _token_ids(self, text: str) -> np.ndarray:
        enc = self.tokenizer.encode(text)
        ids = getattr(enc, "ids", enc)
        return np.asarray(ids, dtype=np.int64)


def _load_tokenizer(p: Path):
    tj = p / "tokenizer.json"
    if tj.exists():
        try:
            from tokenizers import Tokenizer  # part of the transformers stack

            return Tokenizer.from_file(str(tj))
        except ImportError:
            pass
    # fallback: whitespace vocab file "vocab.json" {token: id}
    vj = p / "vocab.json"
    if vj.exists():
        with open(vj) as f:
            vocab = json.load(f)

        class _WsTok:
            def encode(self, text):
                return [vocab[w] for w in re.findall(r"\w+", text.lower())
                        if w in vocab]

        return _WsTok()
    raise FileNotFoundError(f"{p}: need tokenizer.json or vocab.json")


def _load_safetensors_matrix(path: Path) -> np.ndarray:
    """Minimal safetensors reader for the (single) embedding tensor."""
    import struct

    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        base = 8 + n
        name = next(k for k in header if k != "__metadata__")
        info = header[name]
        dtype = {"F32": np.float32, "F16": np.float16}[info["dtype"]]
        shape = info["shape"]
        a, b = info["data_offsets"]
        f.seek(base + a)
        raw = f.read(b - a)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# sentence-boundary chunking (reference vector.rs:561-576: delimiters
# \n . ? !, chunk_size bytes)

_SENT_RE = re.compile(r"[^\n.?!]*[\n.?!]+|[^\n.?!]+$")


def chunk_text(text: str, chunk_size: int) -> list[str]:
    """Split text into chunks of <= chunk_size bytes at sentence boundaries
    (a single sentence longer than chunk_size becomes its own chunk)."""
    if not text:
        return []
    chunks: list[str] = []
    cur = ""
    for m in _SENT_RE.finditer(text):
        sent = m.group(0)
        if cur and len((cur + sent).encode()) > chunk_size:
            chunks.append(cur.strip())
            cur = sent
        else:
            cur += sent
        while len(cur.encode()) > chunk_size:
            chunks.append(cur[:chunk_size].strip())
            cur = cur[chunk_size:]
    if cur.strip():
        chunks.append(cur.strip())
    return chunks
