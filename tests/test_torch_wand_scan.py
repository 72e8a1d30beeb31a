"""Phase-1 WAND scan of the torch port (seekstorm_tpu_torch/ops/wand_scan)
against the JAX reference.

The plain PyTorch version (the one the CPU runs, and the one the CUDA kernel
K1 is held bitwise equal to on the card by chip_smoke.py) is compared on
random synthetic pools with

  * the Pallas kernel wand_pallas.scan_blocks in interpret mode, and
  * the XLA step of wand.wand_scan (PALLAS=0), through phase 2's rung
    tables ranked on the scan's own rung maxima.

Counts must be exact.  UBs must have the same -inf pattern and agree
within rtol 3e-7, the reference's own bound between its two
implementations (XLA may contract a mul+add into an fma).  The rung maxima
the scan returns beside the UBs (ub4, ub16, g1) are maxima, so they must
equal the maxima of its own UBs bit for bit, and phase 2 ranked on them
must equal phase 2 reducing the UBs itself.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekstorm_tpu_torch.ops import wand as pw
from seekstorm_tpu_torch.ops import wand_scan as ws

wand_mod = importlib.import_module("seekstorm_tpu.ops.wand")
wp = importlib.import_module("seekstorm_tpu.ops.wand_pallas")

NW = ws.NW
KP = wand_mod.K_SEL + 1
RTOL = 3e-7


def _synth(rng, *, NBLK=4, V=8, Bq=16, T=2, S=2, R=24, with_filter=False):
    """Random numpy inputs in the layout of tests/test_wand_pallas._synth:
    pools, slot tables and a batch whose last row is all padding."""
    PR = R + 1
    ppool = rng.integers(0, 1 << 32, size=(PR, NW), dtype=np.uint32)
    ppool &= rng.integers(0, 1 << 32, size=(PR, NW), dtype=np.uint32)
    ppool &= rng.integers(0, 1 << 32, size=(PR, NW), dtype=np.uint32)
    vpool = rng.random((PR, NW), np.float32).astype(np.float32) * 3.0
    sp_prow = np.full((V, NBLK), -1, np.int32)
    nxt = 0
    for v in range(V):
        for b in range(NBLK):
            if rng.random() < 0.8 and nxt < R:
                sp_prow[v, b] = nxt
                nxt += 1
    delw = (rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
            & rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
            & rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32))
    sid = ((np.arange(NBLK) * S) // NBLK).astype(np.int32)
    tslot = np.full((Bq, T), -1, np.int32)
    treq = np.zeros((Bq, T), bool)
    tneg = np.zeros((Bq, T), bool)
    wsh = np.zeros((S, Bq, T), np.float32)
    for q in range(Bq - 1):
        npos = int(rng.integers(1, T + 1))
        sl = rng.choice(V, size=npos, replace=False)
        pos = sorted(sl[:-1]) if npos > 1 and rng.random() < 0.3 \
            else sorted(sl)
        negs = [s for s in sl if s not in pos]
        for j, s in enumerate(pos):
            tslot[q, j] = s
            treq[q, j] = rng.random() < 0.3
            wsh[:, q, j] = rng.random(S).astype(np.float32) + 0.1
        for j, s in enumerate(negs):
            tslot[q, len(pos) + j] = s
            tneg[q, len(pos) + j] = True
    filtw = (rng.integers(0, 1 << 32, size=(NBLK, NW), dtype=np.uint32)
             if with_filter else None)
    return dict(ppool=ppool, vpool=vpool, sp_prow=sp_prow, delw=delw,
                sid=sid, slotmap=np.arange(V, dtype=np.int32), tslot=tslot,
                treq=treq, tneg=tneg, wsh=wsh, filtw=filtw)


def _t(x):
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_scan(d, with_counts=True):
    """(allub, cnt, ub4, ub16, g1) of the port's phase 1 on d."""
    prow = d["sp_prow"].T.copy()            # identity slotmap
    return ws.scan_blocks(
        _t(d["ppool"]), _t(d["vpool"]), _t(prow), _t(d["delw"]),
        None if d["filtw"] is None else _t(d["filtw"]), _t(d["tslot"]),
        _t(d["treq"]), _t(d["tneg"]), _t(d["wsh"]), _t(d["sid"]),
        with_counts=with_counts)


def _assert_ub_close(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL)


CASES = [(2, False), (2, True), (4, False), (4, True), (8, False), (8, True)]


@pytest.mark.parametrize("T,with_filter", CASES)
def test_plain_scan_matches_pallas_interpret(T, with_filter):
    d = _synth(np.random.default_rng(3 + T), T=T, with_filter=with_filter)
    allub, cnt, *_ = _port_scan(d)
    V = d["sp_prow"].shape[0]
    Bq = d["tslot"].shape[0]
    w_blk = np.transpose(d["wsh"][d["sid"]], (0, 2, 1))
    filtw = d["filtw"] if with_filter else np.zeros((1, 1), np.uint32)
    ub_p, cnt_p = wp.scan_blocks(
        jnp.asarray(d["ppool"]), jnp.asarray(d["vpool"]),
        jnp.asarray(d["sp_prow"].T.copy()), jnp.asarray(d["delw"]),
        jnp.asarray(filtw), jnp.asarray(d["tslot"]), jnp.asarray(d["treq"]),
        jnp.asarray(d["tneg"]), jnp.asarray(w_blk), V=V, Bq=Bq, T=T,
        with_counts=True, with_filter=with_filter, interpret=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_p))
    assert int(cnt.sum()) > 0
    _assert_ub_close(allub.numpy(), np.asarray(ub_p))


@pytest.mark.parametrize("T", [2, 4, 8])
def test_plain_scan_matches_xla_step(T):
    """Against the reference's default phase 1 (the lax.scan step), read
    through phase 2: counts exact, rung UBs within rtol, and the selected
    regions equal wherever the UBs are untied."""
    d = _synth(np.random.default_rng(5 + T), T=T)
    allub, cnt, *maxima = _port_scan(d)
    rungs = pw._rung_topks(allub, d["sp_prow"].shape[1], maxima)
    V = d["sp_prow"].shape[0]
    Bq = d["tslot"].shape[0]
    S = d["wsh"].shape[0]
    qargs = jnp.asarray(wand_mod._pack_qargs(
        d["slotmap"], d["tslot"], d["treq"], d["tneg"], d["wsh"]))
    out, _ = wand_mod.wand_scan(
        jnp.asarray(d["ppool"][None]), jnp.asarray(d["vpool"][None]),
        jnp.zeros((1, 1, NW), jnp.uint16), jnp.zeros((1, 64), jnp.float32),
        jnp.asarray(d["sp_prow"]),
        jnp.asarray(np.full_like(d["sp_prow"], -1)),
        jnp.asarray(d["delw"]), jnp.asarray(d["sid"]), qargs,
        jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1), jnp.uint32),
        jnp.zeros((1, 1), jnp.float32), V=V, Bq=Bq, T=T, S=S,
        with_counts=True, with_three=True, BS=1, PALLAS=0)
    out = np.asarray(out)
    nr = len(wand_mod.F_LADDER)
    cnt_x = (out[:, 2 * KP * nr].astype(np.int64)
             + (out[:, 2 * KP * nr + 1].astype(np.int64) << 12))
    np.testing.assert_array_equal(cnt.numpy(), cnt_x)
    for f, (vals, ids) in enumerate(rungs):
        ub_x = out[:, 2 * KP * f: 2 * KP * f + KP]
        id_x = out[:, 2 * KP * f + KP: 2 * KP * (f + 1)].astype(np.int64)
        _assert_ub_close(vals.numpy(), ub_x)
        gap = np.ones_like(ub_x, bool)
        gap[:, 1:] &= ub_x[:, 1:] < ub_x[:, :-1] * (1 - 1e-6)
        gap[:, :-1] &= gap[:, 1:]
        same = ids.numpy() == id_x
        assert (same | ~gap | ~np.isfinite(ub_x)).all()


def test_counts_off_gives_zeros_and_same_ub():
    d = _synth(np.random.default_rng(2), T=4)
    ub1, cnt1, *m1 = _port_scan(d, with_counts=True)
    ub0, cnt0, *m0 = _port_scan(d, with_counts=False)
    assert int(cnt0.abs().sum()) == 0 and int(cnt1.sum()) > 0
    for a, b in zip([ub0, *m0], [ub1, *m1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("T,with_filter", CASES)
def test_scan_maxima_are_amax_of_allub(T, with_filter):
    """ub4 / ub16 / g1: the maxima of allub over 4, 16 and 128 consecutive
    buckets of a query's row, bit for bit (numpy, independent of
    rung_maxima)."""
    d = _synth(np.random.default_rng(11 + T), T=T, with_filter=with_filter)
    allub, _, ub4, ub16, g1 = [x.numpy() for x in _port_scan(d)]
    Bq, L1 = allub.shape
    assert np.isfinite(allub).any() and np.isneginf(allub).any()
    for got, width in ((ub4, 4), (ub16, 16), (g1, 128)):
        want = allub.reshape(Bq, L1 // width, width).max(axis=2)
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("T", [2, 4, 8])
def test_rung_topks_take_scan_maxima(T):
    """Phase 2 ranked on the scan's maxima equals phase 2 reducing allub
    itself, values and region ids bit for bit, and matches the reference's
    rung tables on the same UBs."""
    d = _synth(np.random.default_rng(17 + T), T=T)
    allub, _, *maxima = _port_scan(d)
    NBLK = d["sp_prow"].shape[1]
    given = pw._rung_topks(allub, NBLK, maxima)
    reduced = pw._rung_topks(allub, NBLK)
    ref = wand_mod._rung_topks(jnp.asarray(allub.numpy()), NBLK)
    for (gv, gi), (rv, ri), (jv, ji) in zip(given, reduced, ref):
        assert torch.equal(gv.view(torch.int32), rv.view(torch.int32))
        assert torch.equal(gi, ri)
        np.testing.assert_array_equal(_bits(gv), _bits(jv))
        untied = np.isfinite(np.asarray(jv))
        untied[:, 1:] &= np.asarray(jv)[:, 1:] != np.asarray(jv)[:, :-1]
        np.testing.assert_array_equal(gi.numpy()[untied],
                                      np.asarray(ji)[untied])


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.array([bin(int(v)).count("1") for v in x])
    got = ws.popcount32(torch.from_numpy(x.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


def test_tcodes_pack_slot_flags():
    tslot = torch.tensor([[3, -1], [0, 5]], dtype=torch.int32)
    treq = torch.tensor([[True, True], [False, False]])
    tneg = torch.tensor([[False, True], [True, False]])
    assert ws.tcodes(tslot, treq, tneg).tolist() == [[14, -4], [1, 20]]


def test_k1_wrapper_checks_inputs_before_launch():
    """wand_scan_cuda refuses a T it has no kernel for, a wrong shape and
    a pool that is not 16-byte aligned before it builds or launches."""
    d = _synth(np.random.default_rng(1))
    args = dict(ppool=_t(d["ppool"]), vpool=_t(d["vpool"]),
                prow=_t(d["sp_prow"].T.copy()), delw=_t(d["delw"]),
                filtw=None, tslot=_t(d["tslot"]), treq=_t(d["treq"]),
                tneg=_t(d["tneg"]), wshard=_t(d["wsh"]), sid=_t(d["sid"]))
    PR = args["ppool"].shape[0]
    moved = torch.zeros(PR * NW + 1, dtype=torch.float32)[1:].view(PR, NW)
    bad = [("T in", dict(tslot=args["tslot"][:, :1].contiguous())),
           ("vpool", dict(vpool=args["vpool"][:, :NW // 2].contiguous())),
           ("vpool must be 16-byte aligned", dict(vpool=moved))]
    for what, change in bad:
        with pytest.raises(ValueError, match=what):
            ws.wand_scan_cuda(**{**args, **change})


def test_scan_refuses_other_devices():
    d = _synth(np.random.default_rng(1))
    args = [_t(d[k]) for k in ("ppool", "vpool")]
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        ws.scan_blocks(*meta, None, None, None, None, None, None, None, None)
