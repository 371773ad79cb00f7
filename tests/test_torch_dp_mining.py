"""The sharded mining refresh of the PyTorch port
(``train/hard_negatives.py::mine_hard_negatives(mesh=)``) against the JAX
package's mesh refresh on ``devices8[:n]`` and the port's single-device
refresh, on the same numpy weights (the eval worlds' widths).

The index rows are split over the mesh's first axis ("data", as in
data-parallel training) on ``[cpu] * n``, n in {2, 4, 8}.  The mined
(video, proposal) pairs must be equal bit for bit on DiDeMo (13 videos,
52 queries: 273 index rows, pad rows on every mesh), on Charades-STA (7
videos; 1e30 invalid windows and pad rows never mined) and on the tied
world of ``test_torch_train_mining.py`` (two videos with identical
features, so that the order among tied rows across shards decides the
pairs: a bare ``torch.topk`` merge fails it).
"""

import numpy as np
import pytest
import torch

from vfr_tpu.parallel.mesh import make_mesh as j_make_mesh
from vfr_tpu.train.hard_negatives import mine_hard_negatives as j_mine
from vfr_tpu_torch.data.features import banks_to_device
from vfr_tpu_torch.eval.corpus import build_moment_index, make_stream_retriever
from vfr_tpu_torch.parallel.mesh import make_mesh
from vfr_tpu_torch.train.hard_negatives import mine_hard_negatives as t_mine

import torch_eval_world as tw
from test_torch_train_mining import _dup_world

WORLDS = {
    "didemo": lambda: tw.didemo_world(num_videos=13, num_queries=52),
    "charades": lambda: tw.charades_world(num_videos=7, num_queries=21),
    "didemo_tied": _dup_world,
}
_CACHE = {}


def _world(name):
    if name not in _CACHE:
        _CACHE[name] = WORLDS[name]()
    return _CACHE[name]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", list(WORLDS))
def test_mesh_mined_pairs_identical(name, n, devices8):
    world = _world(name)
    count = 6
    single = t_mine(world.tparams, world.tmodel, world.tds, count,
                    batch_size=16)
    jv, jp = j_mine(world.jparams, world.jmodel, world.jds, count,
                    batch_size=16,
                    mesh=j_make_mesh(("data",), devices=devices8[:n]))
    mesh = make_mesh(("data",), devices=[torch.device("cpu")] * n)
    tv, tp = t_mine(world.tparams, world.tmodel, world.tds, count,
                    batch_size=16, mesh=mesh)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, single[0])
    np.testing.assert_array_equal(tp, single[1])
    assert tv.dtype == np.int32 and tv.shape == (world.tds.num_queries,
                                                 count)
    assert (tv != world.tds.video_idx[:, None]).all()
    ok = tv >= 0
    assert (tv[ok] < len(world.tds.video_ids)).all()
    if name == "charades":
        assert world.tds.window_mask[tv[ok], tp[ok]].all()


def test_mesh_mining_from_mesh_banks_and_named_axis():
    """The refresh reads the lead's copy of ``banks_to_device(mesh=)``'s
    banks and splits over a named axis of a two-axis mesh."""
    world = _world("didemo")
    mesh = make_mesh(("data", "model"), shape=(2, 2),
                     devices=[torch.device("cpu")] * 4)
    banks = banks_to_device(world.tds.feature_banks(), mesh=mesh)
    assert list(banks) == [torch.device("cpu")]
    ref = t_mine(world.tparams, world.tmodel, world.tds, 4)
    for axis in (None, "model"):
        got = t_mine(world.tparams, world.tmodel, world.tds, 4,
                     feature_banks=banks[torch.device("cpu")], mesh=mesh,
                     axis=axis)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    index = build_moment_index(world.tparams, world.tmodel, world.tds,
                               with_fingerprint=False)
    with pytest.raises(ValueError, match="fused"):
        make_stream_retriever(world.tmodel, index, 4, topk_method="fused",
                              mesh=mesh, axis="data")
