"""The MCN query tower: GloVe rows -> an LSTM -> the last or the mean live
state -> a linear projection (one, or one a stream); unit length under the
cosine distance.  The functions stay where the ``daemon`` and ``train``
drivers call them; this file hands them to the ``batch`` driver and the
encode counts under the names every tower gives.

A tower file gives:

* ``sizes(cell, cfg)``: its sizes, merged over ``_common.sizes``';
* ``check(s, cfg)``: raises for a configuration its reference does not
  cover;
* ``make_params(s, seed, dev)``: seeded weights in the port's layout;
* ``plan(cfg, dev)``: the stated precision of each query stage;
* ``STAGES``: the query stages, each of which ``lower_share`` lowers alone;
* ``reference_queries(params, s, tokens, lengths, plan)``: the plain
  reference's queries as the retrieval scores them, [S, Q, d];
* ``encode_work(shapes)``: (bytes, operations by dtype) of encoding one
  batch.
"""

from vfrbench import inputs, work
from vfrbench.drivers import _common
from vfrbench.reference import mcn

STAGES = mcn.QUERY_STAGES

sizes = _common.sizes
check = _common.check_model
make_params = inputs.make_params
reference_queries = mcn.retrieval_queries
encode_work = work.encode_work


def plan(cfg, dev):
    """The recurrence's and the projection's precisions of
    ``_common.serving_plan``."""
    full = _common.serving_plan(cfg, dev)
    return {stage: full[stage] for stage in STAGES}
