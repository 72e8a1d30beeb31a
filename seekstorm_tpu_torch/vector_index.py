"""Vector index: per-shard storage, ingestion, commit (quantize + cluster +
persist), and the device tensors.

The port's copy of ``seekstorm_tpu/vector_index.py``, with the same files
on disk.  What differs: clustering runs on a torch device (the index's at
commit, the searching one at the device build), the device tensors are
torch tensors uploaded in one piece and cached per device and shard (built
once under the shard's lock, so concurrent first searches re-cluster and
upload once), and the mesh build (``device_stacked``) groups those
per-shard tensors by mesh position, with no second copy.

Mirrors the reference's vector core storage (reference seekstorm/src/
vector.rs:34-1100 — VectorHeader SoA, per-level cluster layout with
medoid-first records) restated as fixed-layout numpy/HBM tensors:

* committed rows are stored per level, sorted by cluster, medoid first
  (vector.rs:969-1100 commit_vector_shard layout);
* on device, levels concatenate into [n_tiles, 256, d] int8/f32 tiles with
  per-row (scale, zp, qsum, norm2, docid, field) SoA; clusters are
  contiguous row ranges, so nprobe selects the tiles they cover;
* the uncommitted tail keeps raw f32 vectors, scanned exactly by numpy at
  search time (realtime path, vector.rs:1131-1199 analog).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .clustering import cluster_level
from .quantize import (
    QuantizedBatch,
    pad_dim,
    preprocess_vectors,
    quantize_prepared,
)
from .schema import BLOCK_SIZE, Precision, Quantization, VectorSimilarity

TILE = 256


@dataclass
class VecLevel:
    """One committed level's vectors (loaded arrays)."""

    data: np.ndarray         # i8/f32 [N, d_pad]
    scale: np.ndarray
    zp: np.ndarray
    qsum: np.ndarray
    norm2: np.ndarray
    docid: np.ndarray        # i32[N] shard-local doc ids
    fieldid: np.ndarray      # i32[N] vector-field ids
    chunkid: np.ndarray      # i32[N]
    row_cluster: np.ndarray  # i32[N] level-local cluster ids
    cluster_offsets: np.ndarray  # i64[C+1]
    clustered: bool

    @property
    def n(self) -> int:
        return len(self.docid)

    @property
    def n_clusters(self) -> int:
        return len(self.cluster_offsets) - 1


class ShardVectors:
    def __init__(self):
        # uncommitted: (level_local_docid, field_id, chunk_id, raw f32 vec)
        self.level0: list[tuple[int, int, int, np.ndarray]] = []
        self.levels: list[VecLevel] = []
        self._dev: dict = {}      # torch device -> device tensors
        # held while the device tensors are built and while a reload swaps
        # the levels and drops the cache
        self._dev_lock = threading.Lock()


class IndexVectors:
    """Vector engine attached to an Index (reference vector.rs engine)."""

    def __init__(self, index):
        self.index = index
        self.cfg = index.meta.vector
        self.vector_fields = [
            sf for sf in index.schema if sf.index_vector
        ]
        for i, sf in enumerate(self.vector_fields):
            sf.vector_field_id = i
        self.shards = [ShardVectors() for _ in index.shards]
        self.model = None
        from .schema import InferenceType

        if self.cfg.inference in (InferenceType.Model2Vec,
                                  InferenceType.Model2VecCustom):
            from .inference import Model2Vec

            self.model = Model2Vec.load(self.cfg.model)
            if self.cfg.dim == 0:
                self.cfg.dim = self.model.dim

    # ------------------------------------------------------------------
    def ingest(self, shard_id: int, level_local_docid: int, doc: dict) -> None:
        """Extract external embeddings from a document
        (reference external-inference ingest, vector.rs:544-746)."""
        sv = self.shards[shard_id]
        for sf in self.vector_fields:
            val = doc.get(sf.field)
            if val is None:
                continue
            if self.model is not None and isinstance(val, str):
                # internal inference: chunk + embed (reference vector.rs:561)
                from .inference import chunk_text

                chunks = chunk_text(val, self.cfg.chunk_size)
                vecs = list(self.model.encode(chunks)) if chunks else []
            else:
                vecs = self._as_vectors(val)
            for ci, v in enumerate(vecs):
                sv.level0.append(
                    (level_local_docid, sf.vector_field_id, ci, v)
                )

    def _as_vectors(self, val) -> list[np.ndarray]:
        if isinstance(val, np.ndarray):
            val = val.tolist() if val.ndim > 1 else [val]
        if isinstance(val, (list, tuple)):
            if len(val) == 0:
                return []
            if isinstance(val[0], (list, tuple, np.ndarray)):
                return [np.asarray(v, dtype=np.float32) for v in val]
            return [np.asarray(val, dtype=np.float32)]
        return []

    # ------------------------------------------------------------------
    def pack_shard_level(self, shard, lvl_path: Path, lvl_id: int) -> None:
        """Quantize + cluster + persist this shard's level-0 vectors as the
        level's vector section (called from Index._commit_shard)."""
        sv = self.shards[shard.shard_id]
        rows = sv.level0
        d = self.cfg.dim
        if d == 0 and rows:
            d = len(rows[0][3])
        raw = (
            np.stack([r[3] for r in rows]).astype(np.float32)
            if rows
            else np.zeros((0, max(d, 1)), np.float32)
        )
        docid = np.array(
            [lvl_id * BLOCK_SIZE + r[0] for r in rows], dtype=np.int32
        )
        fieldid = np.array([r[1] for r in rows], dtype=np.int32)
        chunkid = np.array([r[2] for r in rows], dtype=np.int32)

        xp = preprocess_vectors(raw, self.cfg.similarity, self.cfg.quantization)
        order, offsets = cluster_level(
            xp, self.cfg.similarity, self.cfg.clustering,
            device=self.index.device,
        )
        clustered = len(offsets) > 2
        xp = xp[order]
        qb = quantize_prepared(xp, self.cfg.precision, self.cfg.quantization)
        row_cluster = np.zeros(len(order), dtype=np.int32)
        for c in range(len(offsets) - 1):
            row_cluster[offsets[c] : offsets[c + 1]] = c

        np.save(lvl_path / "vec_data.npy", qb.data)
        np.save(lvl_path / "vec_scale.npy", qb.scale)
        np.save(lvl_path / "vec_zp.npy", qb.zp)
        np.save(lvl_path / "vec_qsum.npy", qb.qsum)
        np.save(lvl_path / "vec_norm2.npy", qb.norm2)
        np.save(lvl_path / "vec_docid.npy", docid[order])
        np.save(lvl_path / "vec_field.npy", fieldid[order])
        np.save(lvl_path / "vec_chunk.npy", chunkid[order])
        np.save(lvl_path / "vec_cluster.npy", row_cluster)
        np.save(lvl_path / "vec_offsets.npy", offsets)
        with open(lvl_path / "vec.json", "w") as f:
            json.dump({"count": len(order), "clustered": clustered}, f)

    def on_level_complete(self, shard) -> None:
        self.shards[shard.shard_id].level0 = []

    def reload_shard(self, shard) -> None:
        sv = self.shards[shard.shard_id]
        levels = []
        n_levels = shard.full_levels + (1 if shard.partial_on_disk else 0)
        for i in range(n_levels):
            lp = shard.path / f"level_{i}"
            if not (lp / "vec.json").exists():
                continue
            with open(lp / "vec.json") as f:
                meta = json.load(f)
            levels.append(
                VecLevel(
                    data=np.load(lp / "vec_data.npy"),
                    scale=np.load(lp / "vec_scale.npy"),
                    zp=np.load(lp / "vec_zp.npy"),
                    qsum=np.load(lp / "vec_qsum.npy"),
                    norm2=np.load(lp / "vec_norm2.npy"),
                    docid=np.load(lp / "vec_docid.npy"),
                    fieldid=np.load(lp / "vec_field.npy"),
                    chunkid=np.load(lp / "vec_chunk.npy"),
                    row_cluster=np.load(lp / "vec_cluster.npy"),
                    cluster_offsets=np.load(lp / "vec_offsets.npy"),
                    clustered=meta["clustered"],
                )
            )
        with sv._dev_lock:
            sv.levels = levels
            sv._dev = {}

    def load(self) -> None:
        for shard in self.index.shards:
            self.reload_shard(shard)
            # reload level-0 vectors for the partial level (rewrite path)
            sv = self.shards[shard.shard_id]
            sv.level0 = []
            if shard.partial_on_disk and sv.levels:
                lvl = sv.levels[-1]
                base = shard.full_levels * BLOCK_SIZE
                # reconstruct raw-ish vectors from the stored (dequantized)
                # data: exact for F32, reconstruction for i8
                from .quantize import Quantization as Q

                x = lvl.data.astype(np.float32)
                if self.cfg.precision == Precision.I8 and (
                    self.cfg.quantization != Q.Null
                ):
                    x = (x + 128.0) * lvl.scale[:, None] + lvl.zp[:, None]
                for i in range(lvl.n):
                    if lvl.docid[i] >= base:
                        sv.level0.append(
                            (
                                int(lvl.docid[i]) - base,
                                int(lvl.fieldid[i]),
                                int(lvl.chunkid[i]),
                                x[i],
                            )
                        )

    def clear(self) -> None:
        self.shards = [ShardVectors() for _ in self.index.shards]

    def _global_recluster(self, levels, n_rows: int) -> bool:
        """Whether the device build re-clusters the committed union
        (single-level stores already have one global cluster space)."""
        from .schema import ClusteringMode

        return (
            len(levels) > 1
            and self.cfg.clustering.mode != ClusteringMode.Null
            and n_rows >= max(self.cfg.clustering.min_points, 4)
        )

    # ------------------------------------------------------------------
    def _host_arrays(self, shard, device) -> dict:
        """Packed host arrays + metadata for a shard's committed vectors;
        the global re-cluster runs on `device`."""
        sv = self.shards[shard.shard_id]
        levels = sv.levels
        d = pad_dim(max(self.cfg.dim, 1))
        if levels:
            d = levels[0].data.shape[1]
        dtype = (
            np.int8
            if (
                self.cfg.precision == Precision.I8
                and self.cfg.quantization != Quantization.Null
            )
            else np.float32
        )
        N = sum(l.n for l in levels)
        n_tiles = max((N + TILE - 1) // TILE, 1)
        Np = n_tiles * TILE
        data = np.zeros((Np, d), dtype=dtype)
        scale = np.zeros(Np, np.float32)
        zp = np.zeros(Np, np.float32)
        qsum = np.zeros(Np, np.float32)
        norm2 = np.zeros(Np, np.float32)
        docid = np.full(Np, -1, np.int32)
        fieldid = np.zeros(Np, np.int32)

        med_rows = []
        always = []
        r0 = 0
        for l in levels:
            n = l.n
            data[r0 : r0 + n] = l.data
            scale[r0 : r0 + n] = l.scale
            zp[r0 : r0 + n] = l.zp
            qsum[r0 : r0 + n] = l.qsum
            norm2[r0 : r0 + n] = l.norm2
            docid[r0 : r0 + n] = l.docid
            fieldid[r0 : r0 + n] = l.fieldid
            for c in range(l.n_clusters):
                med_rows.append(r0 + int(l.cluster_offsets[c]))
                always.append(not l.clustered)
            r0 += n

        # GLOBAL re-cluster across levels: per-level cluster spaces
        # fragment a query's neighborhood over ~n_levels clusters
        # (measured: 1M docs = 16 levels -> a query's true top-10 spans
        # ~7.6 clusters, capping nprobe recall), so the HBM layout
        # re-clusters the committed union at device-build time — levels
        # stay the durability unit on disk, exactly like the lexical
        # rebuild (lexindex.build_shard_lexical).
        if self._global_recluster(levels, N):
            xf = data[:N].astype(np.float32)
            if dtype == np.int8:
                xf = (xf + 128.0) * scale[:N, None] + zp[:N, None]
            order, offs = cluster_level(
                xf, self.cfg.similarity, self.cfg.clustering, device=device)
            del xf
            for arr in (scale, zp, qsum, norm2, docid, fieldid):
                arr[:N] = arr[:N][order]
            data[:N] = data[:N][order]
            med_rows = [int(o) for o in offs[:-1]]
            always = [False] * (len(offs) - 1)

        C = len(med_rows)
        C_pad = max(1 << (max(C, 1) - 1).bit_length(), 8)
        med_idx = np.zeros(C_pad, np.int64)
        med_idx[:C] = med_rows
        m_valid = np.zeros(C_pad, bool)
        m_valid[:C] = True
        always_scan = np.zeros(C_pad, bool)
        always_scan[:C] = always

        nf = max(len(self.vector_fields), 1)
        nf_pad = max(1 << (nf - 1).bit_length(), 4)

        # cluster -> tile coverage for host tile selection (med_rows are
        # the cluster start rows in both the per-level and global layouts)
        row_of_cluster_start = np.asarray(med_rows + [N], np.int64)
        # rows a cluster, for the mesh's observed-vector count
        sizes = np.zeros(C_pad, np.int64)
        sizes[:C] = np.diff(row_of_cluster_start)

        return {
            "data": data.reshape(n_tiles, TILE, d),
            "scale": scale.reshape(n_tiles, TILE),
            "zp": zp.reshape(n_tiles, TILE),
            "qsum": qsum.reshape(n_tiles, TILE),
            "norm2": norm2.reshape(n_tiles, TILE),
            "docid": docid.reshape(n_tiles, TILE),
            "fieldid": fieldid.reshape(n_tiles, TILE),
            "med_data": data[med_idx],
            "m_scale": scale[med_idx],
            "m_zp": zp[med_idx],
            "m_qsum": qsum[med_idx],
            "m_norm2": norm2[med_idx],
            "m_valid": m_valid,
            "always_scan": always_scan,
            "sizes": sizes,
            "n_tiles": n_tiles,
            "n_rows": N,
            "n_clusters": C,
            "C_pad": C_pad,
            "nf_pad": nf_pad,
            "d": d,
            "quantized": dtype == np.int8,
            "cluster_row_start": row_of_cluster_start,
            # host copy for candidate mapping
            "h_docid": docid,
        }

    _DEV_KEYS = ("data", "scale", "zp", "qsum", "norm2", "docid", "fieldid",
                 "med_data", "m_scale", "m_zp", "m_qsum", "m_norm2",
                 "m_valid", "always_scan", "sizes")

    def device(self, shard, device) -> dict:
        """Per-shard tensors on `device` for the committed vectors, built
        and uploaded once a device, and again after the shard reloads.
        Concurrent first calls build once: the rest wait for it."""
        sv = self.shards[shard.shard_id]
        dev = torch.device(device)
        with sv._dev_lock:
            out = sv._dev.get(dev)
            if out is None:
                h = self._host_arrays(shard, dev)
                sv._dev[dev] = out = {
                    k: torch.from_numpy(np.ascontiguousarray(h[k])).to(dev)
                    if k in self._DEV_KEYS else h[k] for k in h}
            return out

    def device_stacked(self, mesh):
        """The committed vectors over a mesh (the reference's
        device_stacked, vector_index.py:401-453): position d holds its
        shards' tensors, ``device(shard, position's device)``, as they are.
        The reference pads them to the index's common n_tiles / C_pad / d /
        nf_pad and stacks them [SL, ...]; the padding adds no finite
        candidate and no selected cluster, and the one thing the common
        tile count decides, a nprobe scan's corrections' order
        (ops/vector.gathered_order), reads "n_tiles" here.  Returns
        {"per_shard": the shards' device dicts, "positions": per position
        {"device", "shards": its shards' dicts}, "n_tiles", "C_pad",
        "nf_pad", "quantized"}; the per-shard dicts are cached by device."""
        shards = self.index.shards
        SL = len(shards) // mesh.devices.size
        per = [self.device(sh, mesh.devices[s // SL])
               for s, sh in enumerate(shards)]
        return {
            "per_shard": per,
            "positions": [{"device": dev, "shards": per[d * SL:(d + 1) * SL]}
                          for d, dev in enumerate(mesh.devices)],
            "n_tiles": max(h["n_tiles"] for h in per),
            "C_pad": max(h["C_pad"] for h in per),
            "nf_pad": max(h["nf_pad"] for h in per),
            "quantized": per[0]["quantized"],
        }

    def tail_rows(self, shard):
        """Uncommitted tail vectors (realtime path): raw f32 + metadata."""
        sv = self.shards[shard.shard_id]
        start = shard.partial_on_disk
        base = shard.full_levels * BLOCK_SIZE
        rows = [r for r in sv.level0 if r[0] >= start]
        if not rows:
            return None
        raw = np.stack([r[3] for r in rows]).astype(np.float32)
        docid = np.array([base + r[0] for r in rows], np.int64)
        fieldid = np.array([r[1] for r in rows], np.int32)
        chunkid = np.array([r[2] for r in rows], np.int32)
        return raw, docid, fieldid, chunkid
