"""Device vector scan: the quantized distance scan with its masks and top-k
(kernel K4 on CUDA, ``ops/vector_scan.py``), its plain PyTorch version, and
the medoid cluster selection.

Port of ``seekstorm_tpu/ops/vector.py``: ``_dots`` (28), ``_reconstruct``
(50), ``vector_scan_topk`` (74-157) and ``medoid_select`` (160-191).  The
mesh programs (``make_medoid_mesh``, ``make_vector_scan_mesh``) are not
ported (ROADMAP A.9).

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
pads them to four or more), ``fma(sa*zb, Sa+128d, (sa*sb)*core)``; then
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

import torch

from .dense_scan import _sort_desc, fma32

# rows of the scan's plain version scored at a time, per query of the batch
# (bounds its [B, rows] temporaries, float64 ones among them)
REF_ROWS = 1 << 22


@contextlib.contextmanager
def full_f32():
    """float32 matmuls in full float32 on CUDA (TF32 off) inside the block.
    The reference asks ``Precision.HIGHEST`` (its ops/vector.py:37-47): a
    product in fewer mantissa bits flips near-tie ranks, and the f32 scan
    and the medoid scores exist for exact scoring."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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


def vector_scan_ref(data, r_scale, r_zp, r_qsum, r_norm2, row_docid,
                    row_field, deleted, tile_ids, field_ok, q_data, q_scale,
                    q_zp, q_qsum, q_norm2, score_min, *, k: int,
                    quantized: bool, euclidean: bool, with_counts: bool,
                    exhaustive: bool, use_field_filter: bool):
    """Plain PyTorch form of the reference's ``vector_scan_topk``, same
    arguments and returns: (scores f32[B,k], rows i32[B,k] global row ids,
    counts i32[B]).

    data i8/f32 [n_tiles, T, d]; r_* f32[n_tiles, T]; row_docid / row_field
    i32[n_tiles, T] (docid -1 = padding); deleted bool[n_docs_pad] by
    docid; tile_ids i32[NT] the selected tiles (-1 = padding; ignored when
    exhaustive); field_ok bool[NF] by field id; q_data i8/f32 [B, d];
    q_* and score_min f32[B].  Rows are scored a chunk of tiles at a time
    and each chunk's top-kk kept by a stable sort, so ties keep the lower
    position as ``lax.top_k`` does; -inf entries past the matches and the
    ``kk < k`` padding (-inf, row 0) are the reference's too."""
    n_tiles, T, d = data.shape
    B = q_data.shape[0]
    dev = data.device
    if exhaustive:
        tids = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    else:
        tids = tile_ids.long()
    NT = tids.shape[0]
    kk = min(k, NT * T)
    step = max(REF_ROWS // max(B, 1) // T, 1)
    counts = torch.zeros(B, dtype=torch.int64, device=dev)
    cand_s, cand_r = [], []
    local = torch.arange(T, dtype=torch.int64, device=dev)
    for a in range(0, NT, step):
        tsel = tids[a:a + step]
        tc = tsel.clamp(min=0)
        rows = data[tc].reshape(-1, d)
        flat = lambda x: x[tc].reshape(-1)  # noqa: E731
        docid = flat(row_docid).long()
        scores = _scores(q_data, q_scale, q_zp, q_qsum, q_norm2, rows,
                         flat(r_scale), flat(r_zp), flat(r_qsum),
                         flat(r_norm2), quantized, euclidean,
                         gathered=not exhaustive and NT > 1)
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
    ts, rows = merge_candidates(torch.cat(cand_s, dim=1),
                                torch.cat(cand_r, dim=1), k)
    return ts, rows, counts.to(torch.int32)


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
