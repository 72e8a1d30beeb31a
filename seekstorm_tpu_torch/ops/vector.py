"""Device vector scan: the quantized distance scan with its masks and top-k
(kernel K4 on CUDA, ``ops/vector_scan.py``), its plain PyTorch version, and
the medoid cluster selection.

Port of ``seekstorm_tpu/ops/vector.py``: ``_dots`` (28), ``_reconstruct``
(50), ``vector_scan_topk`` (74-157), ``medoid_select`` (160-191), and the
mesh programs ``make_medoid_mesh`` (202) and ``make_vector_scan_mesh`` (247)
as ``medoid_mesh`` and ``vector_scan_mesh``, which run the one-device
functions on each position's shards and gather on the lead device.

Vectors live on the device as [n_tiles, T=256, d] int8 (or f32) with per-row
affine stats (scale, zero point, qsum) and exact pre-quantization norms; the
scan is ``Q = q_i8 @ tiles_i8^T`` with int32 accumulation, the rank-1 affine
corrections of ``quantize.py``, the norm trick for Euclidean, the
delete/field/threshold masks, then the top-k by (score desc, position asc),
the order ``lax.top_k`` keeps.

The reference's CPU backend contracts the corrections into fused
multiply-adds, and which product it fuses first depends on the program
(found against every order, with and without fma, at batches of 1 to 64
and 1 to 16 tiles): where the rows come straight from their arrays (the
exhaustive scan, the medoids) ``fma(sa*sb, core, (sa*zb)*(Sa+128d))``;
where the scan gathers two or more selected tiles first (the serving path
pads them to four or more) from a pool of two or more tiles,
``fma(sa*zb, Sa+128d, (sa*sb)*core)`` (``gathered_order``; a one-tile pool
is read whole, as by the exhaustive scan); then
``fma(sb*za, Sb+128d, .)`` and ``fma(d*za, zb, .)`` in both.  The plain
version repeats that order with ``fma32`` and K4 with ``__fmaf_rn``, so the
i8 scan states no tolerance.  (At some odd batches, 3 and 5 of those tried,
the reference's gathered scan mixes the two orders across its vectorized
loop and its remainder; its scores then differ from the port's by a
rounding of the corrections.)  The Euclidean ``-((|q|^2 + |r|^2) - 2 dots)``
is the same either way (2*dots is exact).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .dense_scan import _sort_desc, fma32

# rows of the scan's plain version scored at a time, per query of the batch
# (bounds its [B, rows] temporaries, float64 ones among them)
REF_ROWS = 1 << 22


_F32 = {"lock": threading.Lock(), "depth": 0, "prev": False}


@contextlib.contextmanager
def full_f32():
    """float32 matmuls in full float32 on CUDA (TF32 off) inside the block.
    The reference asks ``Precision.HIGHEST`` (its ops/vector.py:37-47): a
    product in fewer mantissa bits flips near-tie ranks, and the f32 scan
    and the medoid scores exist for exact scoring.  The switch is global to
    the process, so blocks of several threads nest: TF32 stays off until
    the last of them ends, and then gets its earlier setting back."""
    with _F32["lock"]:
        if _F32["depth"] == 0:
            _F32["prev"] = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _F32["depth"] += 1
    try:
        yield
    finally:
        with _F32["lock"]:
            _F32["depth"] -= 1
            if _F32["depth"] == 0:
                torch.backends.cuda.matmul.allow_tf32 = _F32["prev"]


def _dots(q_data, rows, quantized: bool):
    """q [B, d] . rows [N, d]^T as f32 [B, N].  i8 values multiply exactly
    in f32 while every partial sum stays below 2^24 (d <= 1024: |Q| <=
    d*128*128); wider vectors sum exact f32 products of 1,024-wide slices
    in int64."""
    with full_f32():
        if not quantized:
            return q_data @ rows.T
        d = q_data.shape[1]
        qf, rf = q_data.float(), rows.float()
        if d <= 1024:
            return qf @ rf.T
        acc = None
        for a in range(0, d, 1024):
            part = (qf[:, a:a + 1024] @ rf[:, a:a + 1024].T).long()
            acc = part if acc is None else acc + part
        return acc.float()


def _reconstruct(Q, q_scale, q_zp, q_qsum, r_scale, r_zp, r_qsum, d,
                 quantized, gathered=False):
    """Affine-corrected dot products (see quantize.reconstruct_dot), in the
    reference's contracted order for rows straight from their arrays or
    gathered from two or more selected tiles (module docstring)."""
    if not quantized:
        return Q
    Sa = q_qsum[:, None]
    Sb = r_qsum[None, :]
    sa = q_scale[:, None]
    za = q_zp[:, None]
    sb = r_scale[None, :]
    zb = r_zp[None, :]
    core = Q + 128.0 * Sa + 128.0 * Sb + 16384.0 * d

    def f(a, b, c):
        return fma32(*torch.broadcast_tensors(a, b, c))

    if gathered:
        acc = f(sa * zb, Sa + 128.0 * d, (sa * sb) * core)
    else:
        acc = f(sa * sb, core, (sa * zb) * (Sa + 128.0 * d))
    acc = f(sb * za, Sb + 128.0 * d, acc)
    return f(d * za, zb, acc)


def _scores(q_data, q_scale, q_zp, q_qsum, q_norm2, rows, r_scale, r_zp,
            r_qsum, r_norm2, quantized, euclidean, gathered=False):
    d = rows.shape[1]
    Q = _dots(q_data, rows, quantized)
    dots = _reconstruct(Q, q_scale, q_zp, q_qsum, r_scale, r_zp, r_qsum, d,
                        quantized, gathered)
    if euclidean:
        return -(q_norm2[:, None] + r_norm2[None, :] - 2.0 * dots)
    return dots


def _take_ok(flags, idx):
    """flags[idx] for idx >= 0, True past the end (jnp.take's fill for a
    bool array)."""
    n = flags.shape[0]
    return (idx >= n) | flags[idx.clamp(max=n - 1)]


def _candidates(data, r_scale, r_zp, r_qsum, r_norm2, row_docid, row_field,
                deleted, field_ok, q_data, q_scale, q_zp, q_qsum, q_norm2,
                score_min, tids, kk, *, quantized, euclidean, with_counts,
                gathered, use_field_filter):
    """Each chunk of the slots ``tids``' top-kk by a stable sort, laid out
    in slot order: (scores f32[B, M], global rows [B, M], counts i64[B])."""
    T, d = data.shape[1], data.shape[2]
    B = q_data.shape[0]
    dev = data.device
    step = max(REF_ROWS // max(B, 1) // T, 1)
    counts = torch.zeros(B, dtype=torch.int64, device=dev)
    cand_s, cand_r = [], []
    local = torch.arange(T, dtype=torch.int64, device=dev)
    for a in range(0, tids.shape[0], step):
        tsel = tids[a:a + step]
        tc = tsel.clamp(min=0)
        rows = data[tc].reshape(-1, d)
        flat = lambda x: x[tc].reshape(-1)  # noqa: E731
        docid = flat(row_docid).long()
        scores = _scores(q_data, q_scale, q_zp, q_qsum, q_norm2, rows,
                         flat(r_scale), flat(r_zp), flat(r_qsum),
                         flat(r_norm2), quantized, euclidean,
                         gathered=gathered)
        valid = (docid >= 0) & (tsel >= 0).repeat_interleave(T)
        row_ok = valid & ~_take_ok(deleted, docid.clamp(min=0))
        if use_field_filter:
            row_ok &= _take_ok(field_ok, flat(row_field).long().clamp(min=0))
        mask = row_ok[None, :] & (scores >= score_min[:, None])
        scores = torch.where(mask, scores,
                             torch.full_like(scores, float("-inf")))
        if with_counts:
            counts += mask.sum(dim=1)
        ts, ti = _sort_desc(scores)
        kc = min(kk, scores.shape[1])
        cand_s.append(ts[:, :kc])
        cand_r.append((tc[:, None] * T + local).reshape(-1)[ti[:, :kc]])
    return torch.cat(cand_s, dim=1), torch.cat(cand_r, dim=1), counts


def gathered_order(exhaustive: bool, NT: int, n_tiles: int) -> bool:
    """Whether a scan of NT slots over a pool of n_tiles tiles takes the
    corrections' order of a scan that gathers its tiles (module docstring):
    the reference's XLA gathers two or more selected slots, unless the pool
    holds a single tile, which it reads whole (a one-tile shard scanned for
    nprobe).  K4 takes the same flag."""
    return not exhaustive and NT > 1 and n_tiles > 1


def _slots(data, tile_ids, exhaustive):
    if exhaustive:
        return torch.arange(data.shape[0], dtype=torch.int64,
                            device=data.device)
    return tile_ids.long()


def vector_scan_ref(data, r_scale, r_zp, r_qsum, r_norm2, row_docid,
                    row_field, deleted, tile_ids, field_ok, q_data, q_scale,
                    q_zp, q_qsum, q_norm2, score_min, *, k: int,
                    quantized: bool, euclidean: bool, with_counts: bool,
                    exhaustive: bool, use_field_filter: bool,
                    pool_tiles: int = 0):
    """Plain PyTorch form of the reference's ``vector_scan_topk``, same
    arguments and returns: (scores f32[B,k], rows i32[B,k] global row ids,
    counts i32[B]).  pool_tiles: the tile count whose corrections' order
    (gathered_order) the scan takes, a mesh's common padded count; 0 reads
    data's own.

    data i8/f32 [n_tiles, T, d]; r_* f32[n_tiles, T]; row_docid / row_field
    i32[n_tiles, T] (docid -1 = padding); deleted bool[n_docs_pad] by
    docid; tile_ids i32[NT] the selected tiles (-1 = padding; ignored when
    exhaustive); field_ok bool[NF] by field id; q_data i8/f32 [B, d];
    q_* and score_min f32[B].  Rows are scored a chunk of tiles at a time
    and each chunk's top-kk kept by a stable sort, so ties keep the lower
    position as ``lax.top_k`` does; -inf entries past the matches and the
    ``kk < k`` padding (-inf, row 0) are the reference's too."""
    tids = _slots(data, tile_ids, exhaustive)
    NT = tids.shape[0]
    s, r, counts = _candidates(
        data, r_scale, r_zp, r_qsum, r_norm2, row_docid, row_field, deleted,
        field_ok, q_data, q_scale, q_zp, q_qsum, q_norm2, score_min, tids,
        min(k, NT * data.shape[1]), quantized=quantized, euclidean=euclidean,
        with_counts=with_counts,
        gathered=gathered_order(exhaustive, NT, pool_tiles or data.shape[0]),
        use_field_filter=use_field_filter)
    ts, rows = merge_candidates(s, r, k)
    return ts, rows, counts.to(torch.int32)


def vector_scan_split_ref(data, r_scale, r_zp, r_qsum, r_norm2, row_docid,
                          row_field, deleted, tile_ids, field_ok, q_data,
                          q_scale, q_zp, q_qsum, q_norm2, score_min, *,
                          k: int, n_ranges: int, quantized: bool,
                          euclidean: bool, with_counts: bool,
                          exhaustive: bool, use_field_filter: bool):
    """The plain form of K4's split, same arguments and returns as
    vector_scan_ref (and equal to it): each of ``n_ranges`` contiguous slot
    ranges [g*NT//G, (g+1)*NT//G) keeps its own top kk = min(k, NT*T) by
    (score desc, position asc), then the ranges' lists, in range order,
    are merged by one stable sort.  A range's rows keep the position order
    inside it, and range order is position order across ranges, so ties
    resolve as in one scan.  Empty ranges (G > NT) add nothing."""
    tids = _slots(data, tile_ids, exhaustive)
    NT, T = tids.shape[0], data.shape[1]
    kk = min(k, NT * T)
    G = n_ranges
    lists_s, lists_r = [], []
    counts = torch.zeros(q_data.shape[0], dtype=torch.int64,
                         device=data.device)
    for g in range(G):
        a, b = g * NT // G, (g + 1) * NT // G
        if a == b:
            continue
        s, r, c = _candidates(
            data, r_scale, r_zp, r_qsum, r_norm2, row_docid, row_field,
            deleted, field_ok, q_data, q_scale, q_zp, q_qsum, q_norm2,
            score_min, tids[a:b], kk, quantized=quantized,
            euclidean=euclidean, with_counts=with_counts,
            gathered=gathered_order(exhaustive, NT, data.shape[0]),
            use_field_filter=use_field_filter)
        s, r = merge_candidates(s, r, min(kk, (b - a) * T))
        lists_s.append(s)
        lists_r.append(r.long())
        counts += c
    ts, rows = merge_candidates(torch.cat(lists_s, dim=1),
                                torch.cat(lists_r, dim=1), k)
    return ts, rows, counts.to(torch.int32)


KEY_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _keys(v, pos):
    """K4's 64-bit ranking keys, ascending: the order-mapped score above the
    position, -0 tied with +0 (numpy, v f32 and pos uint64 of one shape)."""
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    order = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return ((~order).astype(np.uint64) << np.uint64(32)) | pos


def vector_scan_running_ref(data, r_scale, r_zp, r_qsum, r_norm2, row_docid,
                            row_field, deleted, tile_ids, field_ok, q_data,
                            q_scale, q_zp, q_qsum, q_norm2, score_min, *,
                            k: int, n_ranges: int, quantized: bool,
                            euclidean: bool, with_counts: bool,
                            exhaustive: bool, use_field_filter: bool):
    """The plain form of K4's running scan (k <= 64), its thresholds
    included; same arguments and returns as vector_scan_ref, and equal to
    it when the thresholds are exact.  G = n_ranges (1 <= G <= NT)
    contiguous slot ranges walk their slots in turns, one slot each a turn
    (one order the CTAs may take).  A range admits a row only if its key
    is below the smallest of: its own list's kk-th key; gthr, the kk-th
    smallest of the ranges' first-slot best keys plus one (the probe pass),
    lowered to every range's kk-th; and the largest of kk buckets plus one,
    bucket b the best key found by the ranges g = b (mod kk).  The merge
    takes the lists' entries at or below min(gthr, largest bucket).  A
    query whose merge finds fewer than kk entries gets NaN scores and row
    -1 there, which no scan returns."""
    tids = _slots(data, tile_ids, exhaustive)
    NT, T = tids.shape[0], data.shape[1]
    B, G, kk = q_data.shape[0], n_ranges, k
    if not (k <= 64 and 1 <= G <= NT):
        raise ValueError(f"the running scan takes k <= 64 and 1 <= G <= NT, "
                         f"got k={k}, G={G}, NT={NT}")
    vals = np.empty((B, NT * T), np.float32)
    counts = torch.zeros(B, dtype=torch.int64)
    for i in range(NT):
        s, r, c = _candidates(
            data, r_scale, r_zp, r_qsum, r_norm2, row_docid, row_field,
            deleted, field_ok, q_data, q_scale, q_zp, q_qsum, q_norm2,
            score_min, tids[i:i + 1], T, quantized=quantized,
            euclidean=euclidean, with_counts=with_counts,
            gathered=gathered_order(exhaustive, NT, data.shape[0]),
            use_field_filter=use_field_filter)
        at = i * T + (r % T).cpu().numpy()
        np.put_along_axis(vals, at, s.cpu().numpy(), axis=1)
        counts += c.cpu()
    keys = _keys(vals, np.arange(NT * T, dtype=np.uint64)[None, :])
    one = np.uint64(1)

    def plus_one(x):
        return np.where(x == KEY_MAX, KEY_MAX, x + one)

    bounds = [(g * NT // G, (g + 1) * NT // G) for g in range(G)]
    best = np.stack([keys[:, a * T:(a + 1) * T].min(1) for a, _ in bounds],
                    1)
    gthr = (plus_one(np.sort(best, 1)[:, kk - 1]) if G >= kk
            else np.full(B, KEY_MAX))
    bucket = np.full((B, kk), KEY_MAX)
    for g in range(G):
        bucket[:, g % kk] = np.minimum(bucket[:, g % kk], best[:, g])
    lists = np.full((B, G, kk), KEY_MAX)
    own_thr = np.full((B, G), KEY_MAX)
    for step in range(max(b - a for a, b in bounds)):
        for g, (a, b) in enumerate(bounds):
            if a + step >= b:
                continue
            thr = np.minimum(np.minimum(own_thr[:, g], gthr),
                             plus_one(bucket.max(1)))
            slot = keys[:, (a + step) * T:(a + step + 1) * T]
            admit = np.where(slot < thr[:, None], slot, KEY_MAX)
            lst = np.sort(np.concatenate([lists[:, g], admit], 1), 1)[:, :kk]
            lists[:, g] = lst
            gthr = np.minimum(gthr, lst[:, kk - 1])
            bucket[:, g % kk] = np.minimum(bucket[:, g % kk], lst[:, 0])
            own_thr[:, g] = np.minimum(thr, lst[:, kk - 1])
    bound = plus_one(np.minimum(gthr, bucket.max(1)))
    flat = lists.reshape(B, -1)
    top = np.sort(np.where(flat < bound[:, None], flat, KEY_MAX), 1)[:, :kk]
    found = top != KEY_MAX
    pos = np.where(found, top & np.uint64(0xFFFFFFFF), 0).astype(np.int64)
    scores = np.where(found, np.take_along_axis(vals, pos, 1), np.nan)
    tile = tids.cpu().numpy()[pos // T].clip(min=0)
    rows = np.where(found, tile * T + pos % T, -1)
    dev = data.device
    return (torch.from_numpy(scores.astype(np.float32)).to(dev),
            torch.from_numpy(rows.astype(np.int32)).to(dev),
            counts.to(torch.int32).to(dev))


def merge_candidates(vals, rows, k: int):
    """The top-k of the candidates vals f32[B, M] (rows [B, M] their global
    row ids, laid out in position order) by a stable sort, so ties keep the
    lower position; past the kk = min(k, M) found, the reference's padding
    (-inf, row 0).  Returns (scores f32[B, k], rows i32[B, k])."""
    B, M = vals.shape
    kk = min(k, M)
    ts, sel = _sort_desc(vals)
    ts = ts[:, :kk]
    out = torch.gather(rows, 1, sel[:, :kk]).to(torch.int32)
    if kk < k:
        ts = torch.cat([ts, torch.full((B, k - kk), float("-inf"),
                                       device=vals.device)], dim=1)
        out = torch.cat([out, torch.zeros((B, k - kk), dtype=torch.int32,
                                          device=vals.device)], dim=1)
    return ts, out


def vector_scan_topk(*args, **kw):
    """The scan's plain version for tensors on the CPU, K4 for CUDA tensors
    (a CUDA failure raises; there is no fallback).  Arguments and returns
    as vector_scan_ref."""
    dev = args[0].device
    if dev.type == "cpu":
        return vector_scan_ref(*args, **kw)
    if dev.type == "cuda":
        from .vector_scan import vector_scan_cuda

        return vector_scan_cuda(*args, **kw)
    raise ValueError(f"no vector scan for device {dev}")


def medoid_select(med_data, m_scale, m_zp, m_qsum, m_norm2, m_valid,
                  always_scan, q_data, q_scale, q_zp, q_qsum, q_norm2,
                  cluster_thr, *, quantized: bool, euclidean: bool,
                  nprobe: int):
    """Score medoids and select top-nprobe clusters per query
    (reference vector.rs:1300-1392).  nprobe=0 selects all valid clusters.
    Returns (sel bool[B, C_pad], scores f32[B, C_pad])."""
    scores = _scores(q_data, q_scale, q_zp, q_qsum, q_norm2, med_data,
                     m_scale, m_zp, m_qsum, m_norm2, quantized, euclidean)
    scores = torch.where(m_valid[None, :], scores,
                         torch.full_like(scores, float("-inf")))
    if nprobe > 0:
        kk = min(nprobe, med_data.shape[0])
        thr = torch.topk(scores, kk, dim=1).values[:, -1:]
        sel = scores >= thr
    else:
        sel = m_valid[None, :].expand(q_data.shape[0], -1)
    sel = sel & (scores >= cluster_thr[:, None])
    sel = sel | always_scan[None, :]
    return sel, scores


# ---------------------------------------------------------------------------
# mesh: each position runs the one-device functions on its own shards
# (IndexVectors.device_stacked) and the results gather on the lead device


def _put_all(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def medoid_mesh(positions, q, cluster_thr, *, C_pad: int, quantized: bool,
                euclidean: bool, nprobe: int, lead):
    """Cluster selection over a mesh (the reference's make_medoid_mesh,
    ops/vector.py:202-244): medoid_select on every local shard of every
    position, kept to the shard's real clusters (``sel & m_valid``).
    positions: device_stacked's per-position dicts; q: the queries
    (q_data, q_scale, q_zp, q_qsum, q_norm2) and cluster_thr f32[B], numpy.
    Returns, on `lead`, (any_sel bool[S, C_pad] the batch's union selection
    per shard in (position, local shard) order, False past a shard's own
    C_pad; obs_cl i32[B] clusters and obs_vec i64[B] vectors each query
    observed, summed over shards)."""
    sels, ocl, ovec = [], 0, 0
    for p in positions:
        qd = _put_all(list(q) + [cluster_thr], p["device"])
        for h in p["shards"]:
            sel, _ = medoid_select(
                h["med_data"], h["m_scale"], h["m_zp"], h["m_qsum"],
                h["m_norm2"], h["m_valid"], h["always_scan"], *qd,
                quantized=quantized, euclidean=euclidean, nprobe=nprobe)
            sel = sel & h["m_valid"][None, :]
            any_sel = torch.zeros(C_pad, dtype=torch.bool, device=lead)
            any_sel[:sel.shape[1]] = sel.any(dim=0).to(lead)
            sels.append(any_sel)
            ocl = ocl + sel.sum(dim=1, dtype=torch.int32).to(lead)
            ovec = ovec + (sel * h["sizes"][None, :]).sum(dim=1).to(lead)
    return torch.stack(sels), ocl, ovec


def vector_scan_mesh(positions, tile_ids, field_ok, q, score_min, *, S: int,
                     k: int, quantized: bool, euclidean: bool,
                     with_counts: bool, exhaustive: bool,
                     use_field_filter: bool, pool_tiles: int, lead):
    """The tiled distance scan over a mesh (the reference's
    make_vector_scan_mesh, ops/vector.py:247-292): vector_scan_topk (K4 on
    CUDA) on every local shard of every position, gid = docid * S + shard.
    positions: device_stacked's per-position dicts, each with ``deleted``,
    its shards' deleted masks; tile_ids i32[S, NT_sel] (ignored when
    exhaustive), field_ok bool[nf_pad], q as medoid_mesh's and score_min
    f32[B], numpy; pool_tiles: the mesh's common tile count, which the
    reference's padded pools scan with.  Returns, on `lead`, (ts f32[B,
    S*k], gid i64[B, S*k], counts i32[B]): the shards' candidates
    unmerged, in (position, local shard, k) order, and the summed
    counts."""
    ts_l, gid_l, cnt = [], [], 0
    s = 0
    for p in positions:
        dev = p["device"]
        qd = _put_all(list(q), dev)
        fok, smin = _put_all([field_ok, score_min], dev)
        for h, deleted in zip(p["shards"], p["deleted"]):
            tid = torch.from_numpy(np.ascontiguousarray(tile_ids[s])).to(dev)
            ts, rows, c = vector_scan_topk(
                h["data"], h["scale"], h["zp"], h["qsum"], h["norm2"],
                h["docid"], h["fieldid"], deleted, tid, fok, *qd, smin, k=k,
                quantized=quantized, euclidean=euclidean,
                with_counts=with_counts, exhaustive=exhaustive,
                use_field_filter=use_field_filter, pool_tiles=pool_tiles)
            did = h["docid"].reshape(-1)[rows.long().clamp(min=0)]
            ts_l.append(ts.to(lead))
            gid_l.append((did.long() * S + s).to(lead))
            cnt = cnt + c.to(lead)
            s += 1
    B = ts_l[0].shape[0]
    ts = torch.stack(ts_l).permute(1, 0, 2).reshape(B, S * k)
    gid = torch.stack(gid_l).permute(1, 0, 2).reshape(B, S * k)
    return ts, gid, cnt
