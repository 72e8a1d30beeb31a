"""Dense-path device arrays and executors, on one torch device or on the
positions of a mesh.

Port of ``seekstorm_tpu/parallel/mesh.py::StackedIndex`` (524-1027):
``_imp_arrays`` (567), ``build`` (611), ``run`` (679) with
``_run_imp`` (930) and ``_run_qt_mode`` (840), which both go to the
pair-list scan of ``ops/lexical.py``, ``_tf_arrays`` (592) and
``_ensure_tf`` (645) with ``_run_tf`` (977) for plans of mode "tf"
(``ops/lexical.tf_scan_pairs``), and ``_merge`` with
``merge_shard_results`` (400-410), with ``aux_device`` (554) for the facet
codes, sort keys and filter words of a batch, and ``run_join`` (806) for the
posting-space join (``ops/join.py``), whose plans stay numpy arrays that go
up as tensors.  No plan packing.

A mesh (``Mesh``, ``make_mesh``; ``Index.attach_mesh``) is the port's
counterpart of the reference's ``shard_map`` programs over its "shards"
axis: one process over a list of torch devices, which may repeat a device.
With S shards and D positions, position d owns the shards d*SL ..
d*SL+SL-1 (SL = S // D), holds a StackedIndex of its own shards (keyed by
mesh, position and device, so two positions on one device keep separate
arrays), runs the one-device program on them and sends its per-shard
pages, counts and facet counts to the lead device (position 0), where
``merge_mesh`` merges them as the reference's ``_merge_body`` (417-441)
does: ``MeshStacked.run`` for ``make_sharded_scan_imp`` (444), ``_qt``
(331) and ``_tf`` (484), ``MeshStacked.run_join`` for
``make_sharded_scan_join`` (218).

The shards' arrays are laid end to end in one global-block layout (the
WAND state's), so one K2 launch covers the pairs of every shard: the CSR
remainders (``dev_docid`` as u16 bits in int16, ``dev_imp``), the presence
bitmaps, ``sat1`` per global block and a packed deleted bitmap.  The
auxiliary columns use the same layout (``search._wand_facet_codes``,
``_wand_rank_key``, ``_wand_filter_words``): facet codes
i32[NF, nblk*BLOCK_SIZE], a sort key f32[nblk*BLOCK_SIZE], and the
disallowed words of a facet filter, which ``run`` takes already ORed into
the deleted words (the reference's ``_merge_deleted``, 1031).  The tf arrays
upload on the first tf plan, in the same layout with bases of their own:
the full postings (``pl_docid`` as u16 bits in int16, ``pl_tf`` u16 bits
[P, F]), the doc-length components ``comp`` f32[nblk*BLOCK_SIZE, F] (1.0
where a shard has none) and the dense-term rows ``dense_tf`` u16 bits
[ND, BLOCK_SIZE, F].
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..metrics import METRICS
from ..ops import join as join_ops
from ..ops import lexical as lex_ops
from ..ops.dense_scan import NWORDS
from ..ops.wand import _signature, index_lock, split_layout
from ..schema import BLOCK_SIZE


# the join's temporaries: a group of queries holds about JOIN_LANE_BYTES
# for each lane of its [Bg, V, PW] grid (the window mask, the block-id marks
# and their running max with its indices, the doc ids and impacts the
# searches read, the rank), and the groups are cut to keep that near
# JOIN_GROUP_BYTES (2 GiB); the per-candidate work is smaller still
JOIN_GROUP_BYTES = 1 << 31
JOIN_LANE_BYTES = 40


def _tf_plans(plans) -> bool:
    """Whether the batch's plans range over the tf arrays."""
    return any(p is not None and p.mode == "tf" for p in plans)


class Mesh:
    """The devices of a mesh, in position order: the port's counterpart of
    a ``jax.sharding.Mesh`` with one "shards" axis.  ``devices`` is a numpy
    object array, so ``mesh.devices.size`` reads as in the reference.  A
    device may repeat (``["cuda:0"] * 4`` runs four positions on one card,
    ``["cpu"] * 8`` stands for eight virtual devices); a CUDA device needs a
    card (no fallback)."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            dev = torch.device(d)
            if dev.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        f"mesh device {d!r} requested but CUDA is not "
                        "available")
                if dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                if dev.index >= torch.cuda.device_count():
                    raise ValueError(f"mesh device {d!r}: only "
                                     f"{torch.cuda.device_count()} cards")
            elif dev.type != "cpu":
                raise ValueError(f"unsupported mesh device {d!r}")
            devs.append(dev)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError("a mesh's devices are all CUDA or all CPU")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = ("shards",)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices) -> Mesh:
    """A mesh over `devices` (torch devices or their names), in order."""
    return Mesh(devices)


def merge_mesh(parts, k: int, lead):
    """The reference's ``_merge_body`` (parallel/mesh.py:417-441) across the
    positions of a mesh.  parts: per position d, in position order, (ts
    f32[SL, B, k], gid i64[SL, B, k], cnt [B], fc [NF, B, fcm] or None) on
    its device, with gid = local * S + (d*SL + j) for local shard j.  The
    pages move to `lead` and lie as [B, D*SL*k] in (D, SL, k) order, and a
    stable descending sort takes the top k (ties keep the lower index, as
    ``lax.top_k`` does); counts and facet counts add up in int64.  Returns
    (ts f32[B, k], gid i64[B, k], cnt i64[B], fc i64 or None) on `lead`."""
    ts = torch.cat([p[0].to(lead) for p in parts])
    gid = torch.cat([p[1].to(lead) for p in parts])
    ts, gid = lex_ops.merge_shard_results(ts, gid, k)
    cnt = sum(p[2].to(lead, torch.int64) for p in parts)
    fc = None
    if parts[0][3] is not None:
        fc = sum(p[3].to(lead, torch.int64) for p in parts)
    return ts, gid, cnt, fc


class StackedIndex:
    """The dense path's device tensors for one committed index generation
    on one torch device: of every shard, or of the shards `shards` (a mesh
    position's range) with block, posting and bitmap bases local to them.
    Pages carry global shard ids."""

    def __init__(self, index, device, shards=None):
        self.index = index
        self.device = torch.device(device)
        self.shard_ids = list(range(index.shard_count) if shards is None
                              else shards)
        self._aux: dict = {}
        self._tf = None         # the tf arrays, uploaded on first use
        self._tf_lock = threading.Lock()
        self.build()

    def aux_device(self, key, make):
        """The tensor on this device of an auxiliary array (facet codes, a
        sort key, filter words), keyed by its spec's signature; make()
        makes the host array on a miss only.  Dropped with this object,
        which a commit or delete replaces."""
        hit = self._aux.get(key)
        if hit is None:
            hit = self._aux[key] = torch.from_numpy(
                np.ascontiguousarray(make())).to(self.device)
        return hit

    def build(self):
        idx = self.index
        docid, imp, bitmaps, sat1 = [], [], [], []
        self.block_base, self.post_base, self.bm_base = [], [], []
        nb = npost = nbm = 0
        for s in self.shard_ids:
            lex = idx.shards[s].lexical
            self.block_base.append(nb)
            self.post_base.append(npost)
            self.bm_base.append(nbm)
            n = lex.n_blocks * BLOCK_SIZE
            s1 = np.zeros(n, np.float32)
            if lex.sat1 is not None and len(lex.sat1):
                s1[: len(lex.sat1)] = lex.sat1[:n]
            sat1.append(s1)
            if lex.dev_docid is not None and len(lex.dev_docid):
                docid.append(np.asarray(lex.dev_docid, np.uint16))
                imp.append(np.asarray(lex.dev_imp, np.float32))
                npost += len(lex.dev_docid)
            if lex.bitmaps is not None and len(lex.bitmaps):
                bitmaps.append(np.asarray(lex.bitmaps, np.uint32))
                nbm += len(lex.bitmaps)
            nb += lex.n_blocks
        self.nblk = max(nb, 1)
        self.n_postings = npost
        self.n_bitmaps = nbm

        delw = np.zeros((self.nblk, NWORDS), np.uint32)
        for j, s in enumerate(self.shard_ids):
            sh = idx.shards[s]
            if sh.deleted:
                ids = np.fromiter(sh.deleted, np.int64)
                ids = ids[ids < sh.lexical.n_blocks * BLOCK_SIZE]
                g = self.block_base[j] + (ids >> 16)
                local = ids & 0xFFFF
                np.bitwise_or.at(
                    delw, (g, local >> 5),
                    np.uint32(1) << (local & 31).astype(np.uint32))

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        self.docid = put(np.concatenate(docid).view(np.int16) if docid
                         else np.zeros(1, np.int16))
        self.imp = put(np.concatenate(imp) if imp
                       else np.zeros(1, np.float32))
        self.bitmaps = put(np.concatenate(bitmaps).view(np.int32) if bitmaps
                           else np.zeros((1, NWORDS), np.int32))
        s1 = np.concatenate(sat1) if sat1 else np.zeros(0, np.float32)
        pad = self.nblk * BLOCK_SIZE - len(s1)
        self.sat1 = put(np.concatenate([s1, np.zeros(pad, np.float32)]))
        self.delw_host = delw
        self.delw = put(delw.view(np.int32))

    @property
    def arrays(self):
        return self.docid, self.imp, self.bitmaps, self.sat1, self.delw

    def ensure_tf(self):
        """Upload the tf arrays on first use (the reference's _tf_arrays
        and _ensure_tf): (pl_docid, pl_tf, dense_tf, comp) on this device,
        with each shard's posting and dense-row base.  Concurrent first
        callers upload once, and the bases are set before the arrays."""
        with self._tf_lock:
            if self._tf is None:
                self._tf = self._upload_tf()
            return self._tf

    def _upload_tf(self):
        F = max(len(self.index.indexed_fields), 1)
        docid, tf, dense = [], [], []
        comp = np.ones((self.nblk * BLOCK_SIZE, F), np.float32)
        post_base, dense_base = [], []
        npost = ndense = 0
        for j, s in enumerate(self.shard_ids):
            lex = self.index.shards[s].lexical
            post_base.append(npost)
            dense_base.append(ndense)
            if lex.pl_docid is not None and len(lex.pl_docid):
                docid.append(np.asarray(lex.pl_docid, np.uint16))
                tf.append(np.asarray(lex.pl_tf, np.uint16).reshape(-1, F))
                npost += len(lex.pl_docid)
            if lex.comp is not None and len(lex.comp):
                a = self.block_base[j] * BLOCK_SIZE
                n = min(len(lex.comp), lex.n_blocks * BLOCK_SIZE)
                comp[a:a + n] = lex.comp[:n]
            if lex.dense_tf is not None and len(lex.dense_tf):
                dense.append(np.asarray(lex.dense_tf, np.uint16))
                ndense += len(lex.dense_tf)
        self.tf_post_base, self.tf_dense_base = post_base, dense_base
        self.n_tf_postings = npost
        self.n_tf_dense = ndense

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        return (
            put(np.concatenate(docid).view(np.int16) if docid
                else np.zeros(1, np.int16)),
            put(np.concatenate(tf).view(np.int16) if tf
                else np.zeros((1, F), np.int16)),
            put(np.concatenate(dense).view(np.int16) if dense
                else np.zeros((1, BLOCK_SIZE, F), np.int16)),
            put(comp))

    def pair_tables(self, plans):
        """The shards' pair lists in one layout (numpy), shard-major: (p_blk,
        p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag, local shard j, local
        block); plans are this object's shards' (plans[j] of shard
        shard_ids[j]); for tf plans the ranges lie in the full postings and
        s_bm holds dense-term rows.  Raises if a segment lies outside the
        uploaded arrays; None when no shard has a pair."""
        tf = _tf_plans(plans)
        if tf:
            self.ensure_tf()
        post_base = self.tf_post_base if tf else self.post_base
        bm_base = self.tf_dense_base if tf else self.bm_base
        n_postings = self.n_tf_postings if tf else self.n_postings
        n_bitmaps = self.n_tf_dense if tf else self.n_bitmaps
        parts = []
        T = max((p.s_len.shape[1] for p in plans if p is not None),
                default=0)
        for s, p in enumerate(plans):
            if p is None or not len(p.p_block):
                continue
            P, Tp = p.s_len.shape

            def wide(x, fill):
                out = np.full((P, T), fill, x.dtype)
                out[:, :Tp] = x
                return out

            bm = wide(p.s_bm, -1)
            parts.append((
                (self.block_base[s] + p.p_block).astype(np.int32),
                p.p_query.astype(np.int32),
                p.nreq[p.p_query].astype(np.int32),
                wide(p.s_off, 0) + post_base[s],
                wide(p.s_len, 0),
                np.where(bm >= 0, bm + bm_base[s], -1).astype(np.int32),
                wide(p.s_w, 0),
                wide(p.s_flag, 0),
                np.full(P, s, np.int64),
                p.p_block.astype(np.int64)))
        if not parts:
            return None
        out = [np.concatenate(x) for x in zip(*parts)]
        s_off, s_len, s_bm = out[3], out[4], out[5]
        if ((s_len > 0) & ((s_off < 0)
                           | (s_off + s_len > n_postings))).any():
            raise ValueError("plan segment outside the device postings")
        if (s_bm >= n_bitmaps).any() or (out[0] >= self.nblk).any():
            raise ValueError("plan bitmap or dense row or block outside "
                             "the index")
        return out

    def scan(self, plans, B: int, k: int, fcod=None, fcm: int = 1,
             skey=None, sort_desc: bool = True, disallowed=None,
             boosts=None):
        """This object's shards' share of ``run``: plans[j] of shard
        shard_ids[j] (None where it selected no block); one launch of the
        pair scan (K2 on CUDA) covers every shard's pairs.  Returns (ts
        f32[SL, B, k], gid i64[SL, B, k], cnt i32[B], fc i32[NF, B, fcm] or
        None) on this device, gid = local * S + shard with the global shard
        id; a pass with no pair gives -inf pages and zero counts."""
        S = self.index.shard_count
        SL = len(self.shard_ids)
        dev = self.device
        nf = 0 if fcod is None else fcod.shape[0]
        tables = self.pair_tables(plans)
        if tables is None:
            fc = None if fcod is None else torch.zeros(
                (nf, B, fcm), dtype=torch.int32, device=dev)
            return (torch.full((SL, B, k), float("-inf"), device=dev),
                    torch.zeros((SL, B, k), dtype=torch.int64, device=dev),
                    torch.zeros(B, dtype=torch.int32, device=dev), fc)
        (p_blk, p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag,
         shard, lblk) = tables

        # each pair's output row (shard, query) and its place among that
        # row's pairs; pairs of one row already ascend by block
        row = shard * B + p_q
        order = np.argsort(row, kind="stable")
        n_row = np.bincount(row, minlength=SL * B)
        first = np.cumsum(n_row) - n_row
        col = np.empty(len(row), np.int64)
        col[order] = np.arange(len(row)) - first[row[order]]

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        pairs = [put(x) for x in (p_blk, p_q, p_nreq, s_off, s_len, s_bm,
                                  s_w, s_flag)]
        delw = self.delw if disallowed is None else disallowed
        rank = None
        if skey is not None:
            rank = skey if sort_desc else -skey
        if _tf_plans(plans):
            vals, docs, cnt, fc = lex_ops.tf_scan_pairs(
                (*self.ensure_tf(), delw), pairs,
                put(np.asarray(boosts, np.float32)), k, B, fcod=fcod,
                fcm=fcm, rank=rank)
        else:
            vals, docs, cnt, fc = lex_ops.scan_pairs(
                (*self.arrays[:4], delw), pairs, k, B, fcod=fcod, fcm=fcm,
                rank=rank)
        gshard = np.asarray(self.shard_ids, np.int64)[shard]
        gids = ((put(lblk)[:, None] * BLOCK_SIZE + docs) * S
                + put(gshard)[:, None])
        ts_s, gid_s = lex_ops.merge_rows(
            vals, gids, put(row), put(col), SL * B, int(n_row.max()), k)
        return ts_s.view(SL, B, k), gid_s.view(SL, B, k), cnt, fc

    def run(self, plans, k: int, with_counts: bool, fcod=None, fcm: int = 1,
            skey=None, sort_desc: bool = True, disallowed=None, boosts=None):
        """plans: the per-shard DensePlans (None where a shard selected no
        block), all of the same batch of B queries and of one mode; tf
        plans are scored from the per-field term frequencies under boosts
        f32[F] (numpy), the batch's field boosts.  fcod i32[NF,
        nblk*BLOCK_SIZE] facet codes with code space fcm; skey
        f32[nblk*BLOCK_SIZE] a sort key, under which pages order by (key
        desc or asc by sort_desc, doc asc) and ts holds the rank (the key,
        negated when ascending); disallowed i32[nblk, NWORDS] the deleted
        words with a facet filter's disallowed docs ORed in, scanned in
        place of the deleted words.  All three on this device, in the
        global-block layout.  Returns (ts f32[B, k], gid i64[B, k] with gid
        = local * S + shard, cnt i64[B]; zeros unless with_counts, fcounts
        i64[max(NF, 1), B, fcm]) as numpy."""
        B = next(p.W.shape[0] for p in plans if p is not None)
        part = self.scan([plans[s] for s in self.shard_ids], B, k,
                         fcod=fcod, fcm=fcm, skey=skey, sort_desc=sort_desc,
                         disallowed=disallowed, boosts=boosts)
        return _pages(merge_mesh([part], k, self.device), B, fcm,
                      with_counts)

    def join_pages(self, plans, statics):
        """This object's shards' share of ``run_join``: (ts f32[SL, B, k],
        gid i64[SL, B, k]) on this device, plans[j] of shard
        shard_ids[j]."""
        S = self.index.shard_count
        k, PW, has_bm = statics["k"], statics["PW"], statics["has_bm"]
        Bg = max(1, JOIN_GROUP_BYTES // (JOIN_LANE_BYTES * statics["V"]
                                         * PW))

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        ts_all, gid_all = [], []
        for j, (s, p) in enumerate(zip(self.shard_ids, plans)):
            rowtab = np.where(p["rowtab"] >= 0,
                              p["rowtab"] + self.bm_base[j], -1)
            args = [put(p[n]) for n in ("rows", "packA", "packB", "segp")]
            args += [put(rowtab.astype(np.int32))]
            args += [put(p[n]) for n in ("W", "isreq", "isneg", "nreq")]
            B = args[0].shape[0]
            ts_s, ids_s = [], []
            METRICS.inc("join_groups_total", -(-B // Bg))
            for a in range(0, B, Bg):
                ts, ids = join_ops.join_scan(
                    self.docid, self.imp, self.sat1, self.bitmaps,
                    *[x[a:a + Bg] for x in args], k=k, PW=PW, has_bm=has_bm,
                    post_base=self.post_base[j],
                    sat1_base=self.block_base[j] * BLOCK_SIZE)
                ts_s.append(ts)
                ids_s.append(ids)
            ts_all.append(torch.cat(ts_s))
            gid_all.append(torch.cat(ids_s) * S + s)
        return torch.stack(ts_all), torch.stack(gid_all)

    def run_join(self, plans, statics):
        """The posting-space join (``ops/join.join_scan``) of a batch whose
        plans ``search._build_join_plans`` built: the reference's
        ``run_join`` (806) with ``scan_one_shard_join`` (197) per shard.

        Each shard's plan goes up as tensors; its storage rows and sat1
        index this shard's stretch of the end-to-end arrays
        (``post_base``, ``block_base``) and its bitmap rows are offset by
        ``bm_base``.  The queries run in groups of Bg, at least one, that
        keep a group's [Bg, V, PW] temporaries near JOIN_GROUP_BYTES at
        JOIN_LANE_BYTES a lane; every group keeps the whole batch's
        statics, because the top-k's tie order follows V*PW.  Per-shard
        pages become gid = local * S + shard and merge as the reference's
        ``_merge`` does.  Returns (ts f32[B, k] -inf padded, gid i64[B, k])
        as numpy."""
        return _join_result(
            [self.join_pages([plans[s] for s in self.shard_ids], statics)],
            statics["k"], self.device)


def _pages(merged, B: int, fcm: int, with_counts: bool):
    """merge_mesh's result as ``run`` returns it, numpy."""
    ts, gid, cnt, fc = merged
    cnt = cnt.cpu().numpy()
    if not with_counts:
        cnt[:] = 0
    fcounts = np.zeros((1, B, fcm), np.int64) if fc is None else \
        fc.cpu().numpy()
    return ts.cpu().numpy(), gid.cpu().numpy(), cnt, fcounts


def _join_result(parts, k: int, lead):
    ts, gid, _, _ = merge_mesh(
        [(ts, gid, torch.zeros(1), None) for ts, gid in parts], k, lead)
    METRICS.inc("join_dispatch_total")
    with METRICS.timer("lex_device"):
        return ts.cpu().numpy(), gid.cpu().numpy()


class MeshStacked:
    """The dense path over the positions of a mesh: position d's
    StackedIndex holds shards d*SL .. d*SL+SL-1.  Its ``run`` and
    ``run_join`` take and return what StackedIndex's do; ``nblk``,
    ``block_base``, ``delw_host`` and ``shard_ids`` describe the whole
    index end to end, which is the positions' layouts laid one after
    another, so the search's facet codes, sort keys and filter words are
    built as for one device and ``aux_device`` cuts them into the
    positions' slices."""

    def __init__(self, index, mesh, positions):
        self.index = index
        self.mesh = mesh
        self.device = mesh.lead
        self.positions = positions
        self.shard_ids = list(range(index.shard_count))
        self.block_base = [p.block_base[j] + b0 for p, b0 in zip(
            positions, np.cumsum([0] + [p.nblk for p in positions]))
            for j in range(len(p.shard_ids))]
        self.nblk = sum(p.nblk for p in positions)
        self.delw_host = np.concatenate([p.delw_host for p in positions])

    def aux_device(self, key, make):
        """Each position's slice (``ops/wand.split_layout``) of an
        auxiliary array in the whole index's layout (facet codes, a sort
        key, filter words), on its device, cached on the positions; make()
        runs on a miss only."""
        if all(key in p._aux for p in self.positions):
            return [p._aux[key] for p in self.positions]
        b0 = np.cumsum([0] + [p.nblk for p in self.positions])
        parts = split_layout(np.ascontiguousarray(make()), self.nblk,
                             [(b, p.nblk) for b, p in zip(b0,
                                                          self.positions)])
        return [p.aux_device(key, lambda x=x: x)
                for p, x in zip(self.positions, parts)]

    def _local(self, plans, p):
        return [plans[s] for s in p.shard_ids]

    def run(self, plans, k: int, with_counts: bool, fcod=None, fcm: int = 1,
            skey=None, sort_desc: bool = True, disallowed=None, boosts=None):
        """StackedIndex.run over the mesh: each position scans its own
        shards' pairs (one K2 launch a position on CUDA) and merge_mesh
        merges the pages on the lead device.  fcod, skey and disallowed
        are aux_device's lists."""
        B = next(p.W.shape[0] for p in plans if p is not None)

        def at(x, d):
            return None if x is None else x[d]

        parts = [p.scan(self._local(plans, p), B, k, fcod=at(fcod, d),
                        fcm=fcm, skey=at(skey, d), sort_desc=sort_desc,
                        disallowed=at(disallowed, d), boosts=boosts)
                 for d, p in enumerate(self.positions)]
        return _pages(merge_mesh(parts, k, self.device), B, fcm,
                      with_counts)

    def run_join(self, plans, statics):
        """StackedIndex.run_join over the mesh: each position joins its
        own shards, and the pages merge on the lead device."""
        return _join_result(
            [p.join_pages(self._local(plans, p), statics)
             for p in self.positions], statics["k"], self.device)


def _get(index, key, make):
    sig = _signature(index)
    with index_lock(index, "_torch_dense_lock"):
        states = index.__dict__.setdefault("_torch_dense_states", {})
        hit = states.get(key)
        if hit is None or hit[0] != sig:
            hit = states[key] = (sig, make())
    return hit[1]


def get_stacked(index, device):
    """The index's StackedIndex on `device`, or, with a mesh attached
    (``Index.attach_mesh``; its devices then serve and `device` is not
    read), a MeshStacked over the positions' StackedIndexes, each keyed by
    (mesh, position, device).  Rebuilt after a commit or delete (keyed on
    ops/wand._signature, as the WAND state is); concurrent first callers
    build it once."""
    m = getattr(index, "_mesh", None)
    if m is None:
        device = torch.device(device)
        return _get(index, str(device),
                    lambda: StackedIndex(index, device))
    S, D = index.shard_count, m.devices.size
    if S % D:
        raise ValueError(f"a mesh of {D} positions does not divide "
                         f"{S} shards")
    SL = S // D
    return MeshStacked(index, m, [
        _get(index, (m, d, str(dev)),
             lambda d=d, dev=dev: StackedIndex(
                 index, dev, range(d * SL, (d + 1) * SL)))
        for d, dev in enumerate(m.devices)])
