"""Dense-path device arrays and executor for all shards on one torch device.

Port of ``seekstorm_tpu/parallel/mesh.py::StackedIndex`` (524-1027) for one
device: ``_imp_arrays`` (567), ``build`` (611), ``run`` (679) with
``_run_imp`` (930) and ``_run_qt_mode`` (840), which both go to the
pair-list scan of ``ops/lexical.py``, ``_tf_arrays`` (592) and
``_ensure_tf`` (645) with ``_run_tf`` (977) for plans of mode "tf"
(``ops/lexical.tf_scan_pairs``), and ``_merge`` with
``merge_shard_results`` (400-410), with ``aux_device`` (554) for the facet
codes, sort keys and filter words of a batch, and ``run_join`` (806) for the
posting-space join (``ops/join.py``), whose plans stay numpy arrays that go
up as tensors.  No plan packing and no mesh programs.

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
from ..ops.wand import _signature, index_lock
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


class StackedIndex:
    """The dense path's device tensors for one committed index generation
    on one torch device."""

    def __init__(self, index, device):
        self.index = index
        self.device = torch.device(device)
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
        for sh in idx.shards:
            lex = sh.lexical
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
        for s, sh in enumerate(idx.shards):
            if sh.deleted:
                ids = np.fromiter(sh.deleted, np.int64)
                ids = ids[ids < sh.lexical.n_blocks * BLOCK_SIZE]
                g = self.block_base[s] + (ids >> 16)
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
        for s, sh in enumerate(self.index.shards):
            lex = sh.lexical
            post_base.append(npost)
            dense_base.append(ndense)
            if lex.pl_docid is not None and len(lex.pl_docid):
                docid.append(np.asarray(lex.pl_docid, np.uint16))
                tf.append(np.asarray(lex.pl_tf, np.uint16).reshape(-1, F))
                npost += len(lex.pl_docid)
            if lex.comp is not None and len(lex.comp):
                a = self.block_base[s] * BLOCK_SIZE
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
        """The shards' pair lists in one global layout (numpy), shard-major:
        (p_blk, p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag, shard, local
        block); for tf plans the ranges lie in the full postings and s_bm
        holds dense-term rows.  Raises if a segment lies outside the
        uploaded arrays."""
        tf = _tf_plans(plans)
        if tf:
            self.ensure_tf()
        post_base = self.tf_post_base if tf else self.post_base
        bm_base = self.tf_dense_base if tf else self.bm_base
        n_postings = self.n_tf_postings if tf else self.n_postings
        n_bitmaps = self.n_tf_dense if tf else self.n_bitmaps
        parts = []
        T = max(p.s_len.shape[1] for p in plans if p is not None)
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
        out = [np.concatenate(x) for x in zip(*parts)]
        s_off, s_len, s_bm = out[3], out[4], out[5]
        if ((s_len > 0) & ((s_off < 0)
                           | (s_off + s_len > n_postings))).any():
            raise ValueError("plan segment outside the device postings")
        if (s_bm >= n_bitmaps).any() or (out[0] >= self.nblk).any():
            raise ValueError("plan bitmap or dense row or block outside "
                             "the index")
        return out

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
        S = self.index.shard_count
        B = next(p.W.shape[0] for p in plans if p is not None)
        dev = self.device
        (p_blk, p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag,
         shard, lblk) = self.pair_tables(plans)

        # each pair's output row (shard, query) and its place among that
        # row's pairs; pairs of one row already ascend by block
        row = shard * B + p_q
        order = np.argsort(row, kind="stable")
        n_row = np.bincount(row, minlength=S * B)
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
        gids = ((put(lblk)[:, None] * BLOCK_SIZE + docs) * S
                + put(shard)[:, None])
        ts_s, gid_s = lex_ops.merge_rows(
            vals, gids, put(row), put(col), S * B, int(n_row.max()), k)
        ts, gid = lex_ops.merge_shard_results(
            ts_s.view(S, B, k), gid_s.view(S, B, k), k)
        cnt = cnt.cpu().numpy().astype(np.int64)
        if not with_counts:
            cnt[:] = 0
        fcounts = np.zeros((1, B, fcm), np.int64) if fc is None else \
            fc.cpu().numpy().astype(np.int64)
        return ts.cpu().numpy(), gid.cpu().numpy(), cnt, fcounts

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
        S = self.index.shard_count
        k, PW, has_bm = statics["k"], statics["PW"], statics["has_bm"]
        Bg = max(1, JOIN_GROUP_BYTES // (JOIN_LANE_BYTES * statics["V"]
                                         * PW))

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        ts_all, gid_all = [], []
        for s, p in enumerate(plans):
            rowtab = np.where(p["rowtab"] >= 0,
                              p["rowtab"] + self.bm_base[s], -1)
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
                    post_base=self.post_base[s],
                    sat1_base=self.block_base[s] * BLOCK_SIZE)
                ts_s.append(ts)
                ids_s.append(ids)
            ts_all.append(torch.cat(ts_s))
            gid_all.append(torch.cat(ids_s) * S + s)
        ts, gid = lex_ops.merge_shard_results(torch.stack(ts_all),
                                              torch.stack(gid_all), k)
        METRICS.inc("join_dispatch_total")
        with METRICS.timer("lex_device"):
            return ts.cpu().numpy(), gid.cpu().numpy()


def get_stacked(index, device) -> StackedIndex:
    """The index's StackedIndex on `device`, rebuilt after a commit or
    delete (keyed on ops/wand._signature, as the WAND state is);
    concurrent first callers build it once."""
    device = torch.device(device)
    sig = _signature(index)
    with index_lock(index, "_torch_dense_lock"):
        states = index.__dict__.setdefault("_torch_dense_states", {})
        hit = states.get(str(device))
        if hit is None or hit[0] != sig:
            hit = states[str(device)] = (sig, StackedIndex(index, device))
    return hit[1]
