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


INPUTS = {
    "ties": lambda rng: (_ties(rng, 12, 3 * NW), True),
    "ties_reduced": lambda rng: (_ties(rng, 12, 3 * NW), False),
    "one_block": lambda rng: (_ties(rng, 9, NW), True),
    "short": lambda rng: (_ties(rng, 9, 64, 20, p_none=0.3), False),
    "shortest": lambda rng: (_ties(rng, 9, 16, 8, p_none=0.3), False),
    "padded": lambda rng: (_ties(rng, 9, 512), False),
    "rank_by_key": lambda rng: (_rank_keys(rng, 12, 2 * NW), False),
}


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


@pytest.mark.parametrize("name", list(INPUTS))
def test_rung_select_ref_equals_plain(name):
    """K6's stages restated in numpy (radix selects of the groups, then of
    the selected groups' lanes past the kg-th group maximum) equal
    _rung_topks bit for bit, ids included, on the same inputs."""
    rng = np.random.default_rng(100 + len(name))
    x, with_maxima = INPUTS[name](rng)
    allub = torch.from_numpy(x)
    maxima = _maxima(allub, with_maxima)
    want = wg._rung_topks(allub, 0, maxima)
    got = wg.rung_select_ref(
        x, None if maxima is None else [m.numpy() for m in maxima])
    for (wv, wi), (gv, gi) in zip(want, got):
        np.testing.assert_array_equal(wv.numpy().view(np.int32),
                                      gv.view(np.int32))
        np.testing.assert_array_equal(wi.numpy(), gi)


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


def test_k6_refuses_other_devices():
    with pytest.raises(ValueError):
        wg.rung_topks(torch.zeros((2, NW), device="meta"), 1)
