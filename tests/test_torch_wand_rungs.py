"""WAND phase 2 of the torch port (seekstorm_tpu_torch/ops/wand_rungs:
rung_topks, kernel K6 on CUDA) against the JAX reference.

On the CPU rung_topks runs its plain version (_rung_topks/_topk_lanes),
held against the reference's _rung_topks on the same UBs: values bit for
bit, region ids equal wherever the values are untied (the reference's
lax.top_k and the port's stable sort agree on untied entries; within a
tie class the port follows _topk_lanes' group order, which K6 keeps).
The cases are those tests/test_torch_wand.py leaves out: equal values in
different groups, rows shorter than a group (L < 128), rungs shorter than
K_SEL+1 (padded with -inf / id 0), a row with nothing matched, and the
rank-by-key input (sort keys, no phase-1 maxima).

K6's two stages are restated in numpy (rung_select_ref on top of
radix_topk_ref) and held bit for bit, ids too, against _rung_topks on
adversarial ties; the kernel meets its plain version on the card
(chip_smoke.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekstorm_tpu_torch.ops import wand_rungs as wg
from seekstorm_tpu_torch.ops import wand_scan as ws
from test_torch_wand import _assert_untied_ids_equal

wand_mod = importlib.import_module("seekstorm_tpu.ops.wand")

NW = ws.NW
KP = wg.KP


def _ties(rng, Bq, L1, levels=400, p_none=0.6):
    """UBs drawn from a few hundred levels, so values tie within and
    across groups; row 1 matches nothing, row 2 is one tie class."""
    x = rng.integers(0, levels, size=(Bq, L1)).astype(np.float32) * 0.25
    x[rng.random(x.shape) < p_none] = -np.inf
    x[1] = -np.inf
    x[2] = 1.5
    return x


def _rank_keys(rng, Bq, L1):
    """Rank-by-key bounds: negated sort keys (an ascending sort) where a
    bucket matched, -inf elsewhere; zeros are -0, as the negation gives.
    Row 1 matches nothing."""
    keys = -rng.integers(0, 40, size=L1).astype(np.float32)
    matched = rng.random((Bq, L1)) < 0.3
    matched[1] = False
    return np.where(matched, keys[None, :], -np.inf).astype(np.float32)


def _few_finite(rng, Bq, L1, n_fin=40):
    """Fewer than K_SEL+1 finite lanes a row: each rung's 65th entry lies
    in the -inf class, which holds far more lanes than the select keeps."""
    x = np.full((Bq, L1), -np.inf, np.float32)
    for q in range(Bq):
        at = rng.choice(L1, size=n_fin if q != 1 else 0, replace=False)
        x[q, at] = rng.permutation(len(at)) * 0.5 + 0.5
        x[q, at[:4]] = 3.0                      # and one tie class
    return x


def _one_bin(rng, Bq, L1):
    """Distinct values in [1, 1.25): one bin of the keys' leading 11 bits
    holds every finite lane, so the select refines it (level 1)."""
    x = (1.0 + rng.random((Bq, L1)) * 0.24).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = -np.inf
    x[1] = -np.inf
    return x


def _last_bits(rng, Bq, L1):
    """Values 1.0 + j ulp, j < 1024, each many times: keys that differ in
    their last 10 bits only (the select's last level, a bin of one key)."""
    j = rng.integers(0, 1024, size=(Bq, L1)).astype(np.uint32)
    x = (np.uint32(0x3F800000) + j).view(np.float32)
    x[1] = -np.inf
    return x


def _signed_zeros(rng, Bq, L1):
    """Rows of +0 and -0 (tied) with a few positives and -inf."""
    x = np.where(rng.random((Bq, L1)) < 0.5, -0.0, 0.0).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = -np.inf
    pos = rng.random(x.shape) < 0.005
    x[pos] = 1.0 + rng.permutation(int(pos.sum())).astype(np.float32)
    x[1] = -np.inf
    return x


INPUTS = {
    "ties": lambda rng: (_ties(rng, 12, 3 * NW), True),
    "few_finite": lambda rng: (_few_finite(rng, 5, 3 * NW), True),
    "few_finite_reduced": lambda rng: (_few_finite(rng, 5, 2 * NW), False),
    "one_bin": lambda rng: (_one_bin(rng, 4, 2 * NW), True),
    "last_bits": lambda rng: (_last_bits(rng, 4, 2 * NW), True),
    "blocks77": lambda rng: (_ties(rng, 3, 77 * NW, levels=1 << 22), True),
    "ties_reduced": lambda rng: (_ties(rng, 12, 3 * NW), False),
    "one_block": lambda rng: (_ties(rng, 9, NW), True),
    "short": lambda rng: (_ties(rng, 9, 64, 20, p_none=0.3), False),
    "shortest": lambda rng: (_ties(rng, 9, 16, 8, p_none=0.3), False),
    "padded": lambda rng: (_ties(rng, 9, 512), False),
    "rank_by_key": lambda rng: (_rank_keys(rng, 12, 2 * NW), False),
}


# the restatement's cases: INPUTS; a row of +0 and -0 ties, where the
# reference's lax.top_k picks its own signs within a tie class (values equal
# as floats, bits not), so it is held against the port's plain version only;
# and 8 blocks of UBs from 12 levels, whose 65th group maximum ties a few
# hundred lanes (K6 selects from its list of the lanes under the cut)
SELECT_INPUTS = dict(
    INPUTS, signed_zeros=lambda rng: (_signed_zeros(rng, 5, 2 * NW), True),
    coarse_ties=lambda rng: (_ties(rng, 4, 8 * NW, levels=12), True))


def _maxima(allub, with_maxima):
    return ws.rung_maxima(allub) if with_maxima else None


@pytest.mark.parametrize("name", list(INPUTS))
def test_rung_topks_match_reference(name):
    rng = np.random.default_rng(len(name))
    x, with_maxima = INPUTS[name](rng)
    allub = torch.from_numpy(x)
    NBLK = max(1, x.shape[1] // NW)
    mine = wg.rung_topks(allub, NBLK, _maxima(allub, with_maxima))
    ref = wand_mod._rung_topks(jnp.asarray(x), NBLK)
    n_untied = 0
    for (mv, mi), (rv, ri) in zip(mine, ref):
        rv = np.asarray(rv)
        assert mv.shape == (x.shape[0], KP) and mi.dtype == torch.int32
        np.testing.assert_array_equal(mv.numpy().view(np.int32),
                                      rv.view(np.int32))
        n_untied += _assert_untied_ids_equal(rv, mi.numpy(), ri)
        # a row with nothing matched: all -inf
        assert np.isneginf(mv.numpy()[1]).all()
    assert n_untied > 0
    if name == "padded" or name.startswith("short"):
        # the last rung holds fewer than K_SEL+1 regions: -inf with id 0
        v, i = mine[2]
        L = x.shape[1] // 16
        assert L < KP
        assert np.isneginf(v.numpy()[:, L:]).all()
        assert (i.numpy()[:, L:] == 0).all()


@pytest.mark.parametrize("name", list(SELECT_INPUTS))
def test_rung_select_ref_equals_plain(name):
    """K6's stages restated in numpy (radix selects of the groups, then of
    the selected groups' lanes past the kg-th group maximum) equal
    _rung_topks bit for bit, ids included, on the same inputs."""
    rng = np.random.default_rng(100 + len(name))
    x, with_maxima = SELECT_INPUTS[name](rng)
    allub = torch.from_numpy(x)
    maxima = _maxima(allub, with_maxima)
    want = wg._rung_topks(allub, 0, maxima)
    got = wg.rung_select_ref(
        x, None if maxima is None else [m.numpy() for m in maxima])
    for (wv, wi), (gv, gi) in zip(want, got):
        np.testing.assert_array_equal(wv.numpy().view(np.int32),
                                      gv.view(np.int32))
        np.testing.assert_array_equal(wi.numpy(), gi)


def test_rung_select_ref_covers_every_path():
    """Over SELECT_INPUTS, the restated stage 2 takes every path: the
    lanes under a finite cut sorted whole or selected from a list, and the
    select over every lane with a bin kept whole, a -inf or tie class that
    overflows the buffer (its first r in candidate order), refinements to
    the second and third level; rungs with the group cut (every rung at 77
    blocks), with a sub-group cut (rungs 2 and 3 below 17 and 65 blocks)
    and with none, and groups of -inf lanes only left out."""
    seen = []
    for name in SELECT_INPUTS:
        rng = np.random.default_rng(100 + len(name))
        x, with_maxima = SELECT_INPUTS[name](rng)
        maxima = _maxima(torch.from_numpy(x), with_maxima)
        trace = []
        wg.rung_select_ref(
            x, None if maxima is None else [m.numpy() for m in maxima],
            trace)
        seen += [dict(t, name=name) for t in trace]
    sel = [t for t in seen if t["path"] == "select"]
    assert {t["path"] for t in seen} == {"sort", "list", "select"}
    assert any(t["level"] == 0 and not t["tie_overflow"] for t in sel)
    assert any(t["tie_overflow"] for t in sel if t["name"] == "few_finite")
    assert any(t["level"] == 1 for t in sel if t["name"] == "one_bin")
    assert any(t["level"] == 2 for t in sel if t["name"] == "last_bits")
    assert any(not t["cut"] and t["rung"] > 0 for t in seen)
    assert all(t["cut"] for t in seen if t["name"] == "blocks77")
    assert max(t["sorted"] for t in sel) > KP
    # rungs 2 and 3 cut by their sub-groups' maxima, and groups of -inf
    # lanes left out
    assert any(t["cut"] and t["rung"] > 0 for t in seen
               if t["name"] == "ties")
    assert any(t["groups"] < t["kg"] for t in seen
               if t["name"] == "few_finite")


RADIX_CASES = {
    # (keys, k, cut, the level that ends the search, overflowed tie bin)
    "spread": (lambda r: r.integers(0, 1 << 32, 8192, dtype=np.uint32),
               65, None, 0, False),
    "tie_class": (lambda r: np.where(r.random(8192) < 0.002,
                                     r.integers(0, 1 << 20, 8192),
                                     0xFF800000).astype(np.uint32),
                  65, None, 0, True),
    "one_bin": (lambda r: (0x3F800000 + r.integers(0, 1 << 21, 4096)
                           ).astype(np.uint32), 65, None, 1, False),
    "last_bits": (lambda r: (0x3F800000 + np.arange(8192) % 1024
                             ).astype(np.uint32), 65, None, 2, False),
    "cut": (lambda r: r.integers(0, 1 << 12, 5000).astype(np.uint32) << 20,
            64, 200 << 20, 0, False),
    "k1": (lambda r: r.integers(0, 3, 1000).astype(np.uint32) << 28,
           1, None, 0, True),
}


@pytest.mark.parametrize("name", list(RADIX_CASES))
def test_radix_topk_ref_paths(name):
    """radix_topk_ref, path by path, against a stable sort by (key,
    index) of the keys at or below the cut."""
    make, k, cut, level, tie = RADIX_CASES[name]
    keys = make(np.random.default_rng(3))
    n = len(keys)
    ok = np.arange(n) if cut is None else np.flatnonzero(keys <= cut)
    want = ok[np.lexsort((ok, keys[ok]))][:k]
    trace = {}
    got = wg.radix_topk_ref(keys, k, 0xFFFFFFFF if cut is None else cut,
                            trace)
    np.testing.assert_array_equal(got, want)
    assert (trace["level"], trace["tie_overflow"]) == (level, tie)


def test_ties_across_groups_follow_group_rank():
    """Equal values in two groups: the group with the larger maximum (then
    the lower group) comes first, whatever the global index says."""
    x = np.full((1, NW), -np.inf, np.float32)
    x[0, 5] = 1.0            # group 0: max 1.0
    x[0, 130] = 2.0          # group 1: max 2.0, a 1.0 beside it
    x[0, 131] = 1.0
    x[0, 300] = 1.0          # group 2: max 1.0
    (v, i), _, _ = wg.rung_topks(torch.from_numpy(x), 1)
    assert v[0, :4].tolist() == [2.0, 1.0, 1.0, 1.0]
    assert i[0, :4].tolist() == [130, 131, 5, 300]
    got = wg.rung_select_ref(x)[0]
    assert got[1][0, :4].tolist() == [130, 131, 5, 300]


def test_radix_topk_ref_orders_by_key_then_index():
    rng = np.random.default_rng(7)
    for n, k in ((65, 65), (300, 1), (8192, 64), (2048, 65)):
        keys = rng.integers(0, 5, size=n).astype(np.uint32) << 28
        want = np.lexsort((np.arange(n), keys))[:k]
        np.testing.assert_array_equal(wg.radix_topk_ref(keys, k), want)
        # a cut that keeps at least k candidates changes nothing
        cut = int(keys[want[-1]])
        np.testing.assert_array_equal(wg.radix_topk_ref(keys, k, cut), want)


def test_desc_keys_order_floats_descending():
    x = np.array([np.inf, 3.0, 1.0, 0.0, -0.0, -1.0, -np.inf], np.float32)
    k = wg.desc_keys(x)
    assert (np.diff(k[[0, 1, 2, 3, 5, 6]].astype(np.int64)) > 0).all()
    assert k[3] == k[4]


def test_k6_wrapper_checks_inputs_before_launch():
    x = torch.zeros((4, NW))
    with pytest.raises(ValueError, match="buckets"):
        wg.wand_rungs_cuda(torch.zeros((4, 40)))
    with pytest.raises(ValueError, match="g1"):
        ub4, ub16, g1 = ws.rung_maxima(x)
        wg.wand_rungs_cuda(x, (ub4, ub16, g1[:, :3]))
    with pytest.raises(ValueError, match="multiple of 128"):
        wg.wand_rungs_cuda(torch.zeros((4, 64)), ws.rung_maxima(x))


def test_k6_rows_start_on_16_bytes():
    """K6 reads rows as float4s: its launcher copies a view that starts
    off 16 bytes and passes an aligned tensor as it is."""
    x = torch.arange(4 * 64 + 1, dtype=torch.float32)
    view = x[1:].view(4, 64)
    assert view.data_ptr() % 16 != 0
    got = wg._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    assert wg._aligned(x) is x


def test_k6_refuses_other_devices():
    with pytest.raises(ValueError):
        wg.rung_topks(torch.zeros((2, NW), device="meta"), 1)
