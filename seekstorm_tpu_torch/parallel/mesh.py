"""Dense-path device arrays and executor for all shards on one torch device.

Port of ``seekstorm_tpu/parallel/mesh.py::StackedIndex`` (524-1027) for one
device in impact mode: ``_imp_arrays`` (567), ``build`` (611), ``run``
(679) with ``_run_imp`` (930) and ``_run_qt_mode`` (840), which both go to
the pair-list scan of ``ops/lexical.py``, and ``_merge`` with
``merge_shard_results`` (400-410), with ``aux_device`` (554) for the facet
codes, sort keys and filter words of a batch.  No plan packing, tf arrays,
mesh or join programs.

The shards' arrays are laid end to end in one global-block layout (the
WAND state's), so one K2 launch covers the pairs of every shard: the CSR
remainders (``dev_docid`` as u16 bits in int16, ``dev_imp``), the presence
bitmaps, ``sat1`` per global block and a packed deleted bitmap.  The
auxiliary columns use the same layout (``search._wand_facet_codes``,
``_wand_rank_key``, ``_wand_filter_words``): facet codes
i32[NF, nblk*BLOCK_SIZE], a sort key f32[nblk*BLOCK_SIZE], and the
disallowed words of a facet filter, which ``run`` takes already ORed into
the deleted words (the reference's ``_merge_deleted``, 1031).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lexical as lex_ops
from ..ops.dense_scan import NWORDS
from ..ops.wand import _signature
from ..schema import BLOCK_SIZE


class StackedIndex:
    """The dense path's device tensors for one committed index generation
    on one torch device."""

    def __init__(self, index, device):
        self.index = index
        self.device = torch.device(device)
        self._aux: dict = {}
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

    def pair_tables(self, plans):
        """The shards' pair lists in one global layout (numpy), shard-major:
        (p_blk, p_q, p_nreq, s_off, s_len, s_bm, s_w, s_flag, shard, local
        block).  Raises if a segment lies outside the uploaded arrays."""
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
                wide(p.s_off, 0) + self.post_base[s],
                wide(p.s_len, 0),
                np.where(bm >= 0, bm + self.bm_base[s], -1).astype(np.int32),
                wide(p.s_w, 0),
                wide(p.s_flag, 0),
                np.full(P, s, np.int64),
                p.p_block.astype(np.int64)))
        out = [np.concatenate(x) for x in zip(*parts)]
        s_off, s_len, s_bm = out[3], out[4], out[5]
        if ((s_len > 0) & ((s_off < 0)
                           | (s_off + s_len > self.n_postings))).any():
            raise ValueError("plan segment outside the device CSR")
        if (s_bm >= self.n_bitmaps).any() or (out[0] >= self.nblk).any():
            raise ValueError("plan bitmap row or block outside the index")
        return out

    def run(self, plans, k: int, with_counts: bool, fcod=None, fcm: int = 1,
            skey=None, sort_desc: bool = True, disallowed=None):
        """plans: the per-shard DensePlans (None where a shard selected no
        block), all of the same batch of B queries.  fcod i32[NF,
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
        arrays = self.arrays if disallowed is None else \
            (*self.arrays[:4], disallowed)
        rank = None
        if skey is not None:
            rank = skey if sort_desc else -skey
        vals, docs, cnt, fc = lex_ops.scan_pairs(arrays, pairs, k, B,
                                                 fcod=fcod, fcm=fcm,
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


def get_stacked(index, device) -> StackedIndex:
    """The index's StackedIndex on `device`, rebuilt after a commit or
    delete (keyed on ops/wand._signature, as the WAND state is)."""
    device = torch.device(device)
    states = index.__dict__.setdefault("_torch_dense_states", {})
    sig = _signature(index)
    hit = states.get(str(device))
    if hit is None or hit[0] != sig:
        hit = states[str(device)] = (sig, StackedIndex(index, device))
    return hit[1]
