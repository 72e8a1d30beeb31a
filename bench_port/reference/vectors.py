"""Plain Euclidean search over the generated vectors, for the check of a
vector cell.  NumPy and PyTorch only, float64, TF32 off.

- ``truth``: each query's exact squared distance to its 10th nearest row
  over committed rows plus the tail (the raw float32 vectors), for recall
  with ties counted.
- ``distances``: the distance that the configuration's scoring gives a
  (query, row) pair: committed rows and the query through the affine i8
  scalar quantization (per vector: zero point the minimum, step
  (max - min) / 255, codes rounded), the distance between the two
  dequantized points; tail rows exactly, as the configuration states.
- ``levels=15`` quantizes to 4 bits: the control of the check.
"""

from __future__ import annotations

import numpy as np
import torch


def dequantize(x: np.ndarray, levels: int = 255) -> np.ndarray:
    """x [n, d] float32 through the affine scalar quantizer with `levels`
    steps, back to float32."""
    x = np.asarray(x, np.float32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    scale = np.maximum((mx - mn) / np.float32(levels), 1e-12).astype(
        np.float32)
    q = np.rint((x - mn[:, None]) / scale[:, None]).clip(0, levels)
    return (scale[:, None] * q + mn[:, None]).astype(np.float32)


class VectorReference:
    def __init__(self, base: np.ndarray, tail: np.ndarray, levels: int = 255):
        self.base = np.asarray(base, np.float32)
        self.tail = np.asarray(tail, np.float32)
        self.n_c = len(self.base)
        self.n = self.n_c + len(self.tail)
        self.levels = levels

    def row(self, i: int) -> np.ndarray:
        return self.base[i] if i < self.n_c else self.tail[i - self.n_c]

    def distances(self, q: np.ndarray, ids) -> np.ndarray:
        """f64 distances of query q to rows `ids` (any out of range: inf)."""
        ids = np.asarray(ids, np.int64)
        out = np.full(len(ids), np.inf)
        ok = (ids >= 0) & (ids < self.n)
        com = ok & (ids < self.n_c)
        if com.any():
            qh = dequantize(q[None], self.levels)[0].astype(np.float64)
            xh = dequantize(self.base[ids[com]], self.levels).astype(
                np.float64)
            out[com] = np.sqrt(((xh - qh) ** 2).sum(axis=1))
        tl = ok & (ids >= self.n_c)
        if tl.any():
            x = self.tail[ids[tl] - self.n_c].astype(np.float64)
            out[tl] = np.sqrt(((x - q.astype(np.float64)) ** 2).sum(axis=1))
        return out

    def truth(self, queries: np.ndarray, k: int = 10, device="cpu",
              rows: int = 1 << 18) -> np.ndarray:
        """Each query's exact squared distance to its k-th nearest row."""
        dev = torch.device(device)
        prev = torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            q = torch.from_numpy(np.asarray(queries, np.float64)).to(dev)
            qn = (q * q).sum(1, keepdim=True)
            best = torch.full((len(q), k), float("inf"), dtype=torch.float64,
                              device=dev)
            for part in (self.base, self.tail):
                for a in range(0, len(part), rows):
                    x = torch.from_numpy(part[a:a + rows]).to(dev).double()
                    d2 = qn + (x * x).sum(1)[None, :] - 2.0 * (q @ x.T)
                    best = torch.cat([best, d2], 1).topk(
                        k, dim=1, largest=False).values
                    del x, d2
            return best[:, -1].cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = prev

    def exhaustive_pages(self, queries: np.ndarray, k: int = 10,
                         device="cpu", rows: int = 1 << 18):
        """(ids [B, k], distances [B, k]) of each query's k nearest rows by
        ``distances``' scoring over every row: the reference in the
        program's place."""
        dev = torch.device(device)
        qs = np.asarray(queries, np.float32)
        qh = torch.from_numpy(dequantize(qs, self.levels)).to(dev).double()
        qr = torch.from_numpy(qs).to(dev).double()
        best_d = torch.full((len(qs), k), float("inf"), dtype=torch.float64,
                            device=dev)
        best_i = torch.full((len(qs), k), -1, dtype=torch.int64, device=dev)
        for part, base, quant in ((self.base, 0, True),
                                  (self.tail, self.n_c, False)):
            for a in range(0, len(part), rows):
                x = part[a:a + rows]
                if quant:
                    x = dequantize(x, self.levels)
                x = torch.from_numpy(x).to(dev).double()
                q = qh if quant else qr
                d2 = ((q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :]
                      - 2.0 * (q @ x.T)).clamp_min(0)
                ids = torch.arange(a + base, a + base + len(x), device=dev)
                cd = torch.cat([best_d, d2.sqrt()], 1)
                ci = torch.cat([best_i, ids.expand(len(qs), -1)], 1)
                # (distance, id) order: ids ascend within a chunk and
                # chunks come in id order, so a stable sort keeps it
                order = torch.sort(cd, dim=1, stable=True).indices[:, :k]
                best_d = cd.gather(1, order)
                best_i = ci.gather(1, order)
                del x, d2, cd, ci
        return best_i.cpu().numpy(), best_d.cpu().numpy()
