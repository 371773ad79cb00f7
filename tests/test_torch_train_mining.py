"""Hard-negative mining of the PyTorch port against the JAX package's
``train/hard_negatives.py::mine_hard_negatives`` on the same numpy weights
and fixture (the eval worlds' widths): the mined (video, proposal) pairs
are identical, on DiDeMo, on Charades-STA (1e30 sentinel windows never
mined) and on a DiDeMo corpus where two videos carry the same features, so
that their index rows tie exactly and the order among tied rows (lowest
row first, as ``jax.lax.top_k``) decides the mined pairs.
"""


import numpy as np
import pytest

from vfr_tpu.data.synthetic import make_didemo_fixture as j_didemo_fix
from vfr_tpu.train.hard_negatives import mine_hard_negatives as j_mine
from vfr_tpu_torch.train.hard_negatives import mine_hard_negatives as t_mine

import torch_eval_world as tw


def _dup_world():
    """A DiDeMo world whose videos 0 and 1 have identical features."""
    fix = j_didemo_fix(num_videos=12, num_queries=48, feature_dim=tw.F,
                       glove_dim=tw.E, seed=10)
    vids = sorted(fix.rgb._table)
    for store in (fix.rgb, fix.flow):
        store._table[vids[0]] = store._table[vids[1]].copy()
    model = dict(joint_dim=tw.J, lstm_hidden=tw.H, stream_weights=(0.5, 0.5),
                 distance="cosine", query_pool="mean")
    data = dict(feature_dim=tw.F, glove_dim=tw.E, use_flow=True)
    return tw._make(data, model, fix, tw.JDidemo, tw.DidemoDataset, 10, True)


@pytest.mark.parametrize("name", ["didemo", "charades", "didemo_tied"])
def test_mined_pairs_identical(name):
    world = {"didemo": tw.didemo_world, "charades": tw.charades_world,
             "didemo_tied": _dup_world}[name]()
    count = 6
    jv, jp = j_mine(world.jparams, world.jmodel, world.jds, count,
                    batch_size=16)
    tv, tp = t_mine(world.tparams, world.tmodel, world.tds, count,
                    batch_size=16)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tp, jp)
    assert tv.dtype == np.int32 and tv.shape == (world.tds.num_queries,
                                                 count)
    assert (tv != world.tds.video_idx[:, None]).all()
    if name == "charades":
        ok = tv >= 0
        assert world.tds.window_mask[tv[ok], tp[ok]].all()
    if name == "didemo_tied":
        # the twins' rows tie: both appear, video 0's row first
        both = [(list(v).index(0), list(v).index(1))
                for v, own in zip(tv, world.tds.video_idx)
                if 0 in v and 1 in v and own not in (0, 1)]
        assert both and all(i < j for i, j in both)


def test_mining_from_device_banks_and_mesh_refused():
    from vfr_tpu_torch.data.features import banks_to_device

    world = tw.didemo_world()
    banks = banks_to_device(world.tds.feature_banks(), device="cpu")
    a = t_mine(world.tparams, world.tmodel, world.tds, 4)
    b = t_mine(world.tparams, world.tmodel, world.tds, 4,
               feature_banks=banks)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(NotImplementedError, match="sharded mining"):
        t_mine(world.tparams, world.tmodel, world.tds, 4, mesh=object())
