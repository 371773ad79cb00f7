"""The stage counts against hand counts at small shapes, and the bound."""

import pytest

from vfrbench import work


def test_encode_hand_count():
    s = {"Q": 2, "live_steps": 5, "E": 3, "H": 2, "layers": 1, "d": 4,
         "streams": 2, "per_stream_proj": False}
    b, ops = work.encode_work(s)
    # 5 live steps x (x W_ih: 2*3*8 + h W_hh: 2*2*8) = 5 * 80
    assert ops["bfloat16"] == 400
    assert ops["float32"] == 2 * 2 * 2 * 4          # Q H d, one projection
    # rows 5*3*4, W (3+2)*8*2 + b 8*4, proj (2*4+4)*4, out 2*2*4*4
    assert b == 60 + 80 + 32 + 48 + 64


def test_score_and_select_hand_count():
    s = {"Q": 3, "N": 10, "streams": 2, "d": 4, "k": 2,
         "index_dtype": "bfloat16", "score_dtype": "bfloat16"}
    b, ops = work.score_work(s)
    assert ops == {"bfloat16": 2 * 3 * 10 * 2 * 4}
    assert b == 2 * 10 * 4 * 2 + 10 * 4 + 2 * 3 * 4 * 4 + 3 * 10 * 4
    b, ops = work.select_work(s)
    assert ops == {} and b == 3 * 10 * 4 + 3 * 2 * 12


def test_train_hand_count():
    s = {"B": 2, "live_steps": 3, "E": 1, "H": 1, "layers": 1, "d": 1,
         "streams": 1, "clips": 1, "F": 1, "P": 1, "hard": 1,
         "per_stream_proj": False}
    ops = work.train_work(s)["float32"]
    lstm = 2 * 3 * 4 * (1 + 1) + 2 * 3 * 4 * (1 + 2)      # 48 + 72
    proj = 3 * 2 * 2                                       # 12
    moment = 2 * (2 * 4 * 1 * 2)                           # rows 4: 32
    pool = 3 * (2 * 2 + 2 * 2)                             # 24
    dist = 3 * (2 * 4 + 2 * 2)                             # 36
    assert ops == lstm + proj + moment + pool + dist


def test_bound_takes_the_larger_and_the_f32_route():
    t, by = work.bound(3.35e12, {})
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = work.bound(0, {"bfloat16": 989e12})
    assert t == pytest.approx(1.0) and by == "operations"
    # f32: the lesser of f32 FMAs and three TF32 products
    t, _ = work.bound(0, {"float32": 67e12})
    assert t == pytest.approx(3 * 67e12 / 495e12)
    assert work.seconds_at_peak({"float32": 67e12}) == pytest.approx(1.0)
