"""Operations and bytes on shapes worked out by hand."""
import pytest

import tiny
from benchkit import flops
from reference.nar import Model


def test_scorer_forward_by_hand():
    # 10 pairs of 2 rows, C 4, matching 2 -> 1 -> out 1
    w = flops.scorer_forward(10, 2, 4, (2, 1), itemsize=2)
    assert w.flops == 2 * 10 * (16 + 4 * 2 + 2 * 1 + 1 * 1)
    weights = 16 + 4 + (4 * 2 + 2) + (2 * 1 + 1) + (1 * 1 + 1)
    assert w.bytes == 2 * (10 * 4 + 2 * 2 * 4 + weights) + 4 * 10
    b = flops.scorer_backward(10, 2, 4, (2, 1), itemsize=2)
    assert b.flops == 2 * w.flops
    assert b.bytes == w.bytes + 2 * (10 * 4 + 2 * 2 * 4) + 4 * weights


def test_ugrnn_by_hand():
    w = flops.ugrnn_forward(valid_steps=3, grid_steps=8, units=5, itemsize=2)
    assert w.flops == 2 * 3 * 5 * 10
    assert w.bytes == 2 * (3 * 10 + 2 * 25 + 8 * 5)
    assert flops.ugrnn_backward(3, 8, 5).flops == 2 * w.flops


def test_least_time_takes_the_larger_bound():
    w = flops.Work(flops=1e12, bytes=1e9)
    assert w.seconds(1e12, 1e12) == pytest.approx(1.0)
    assert flops.Work(1.0, 1e12).seconds(1e12, 1e11) == pytest.approx(10.0)


def test_model_flops_of_the_g1_shapes():
    m = Model(tiny.spec.load_json(tiny.BENCH_DIR / "configs" / "g1.json"))
    s = flops.Shapes.of(m)
    assert (s.user_dim, s.item_dim, s.c) == (71, 406, 1024)
    enc = flops.encoder_flops(s, 1)
    f = 477
    assert enc == 2 * (2 * (f * 1024 + 1024 * 1024) + (1024 * 510 + 255 * 510)
                       + (255 * 510 + 255 * 510) + 255 * 512 + 512 * 1024)
    fwd = flops.model_flops(s, 10, 4, 50, 1000, train=False)
    assert flops.model_flops(s, 10, 4, 50, 1000, train=True) == 3 * fwd
