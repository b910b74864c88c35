"""The rings of input frames: made from the seed, the same for one seed,
different for two."""

import torch

from bench_torch import frames

SHAPE = (4, 40, 64)
BIG_SEED = 2**31 + 12345  # past 32 signed bits, as a check's seeds may be


def test_one_seed_gives_one_ring():
    a = frames.scene_ring(*SHAPE, BIG_SEED, "cpu")
    b = frames.scene_ring(*SHAPE, BIG_SEED, "cpu")
    assert a.dtype == torch.uint8 and a.shape == SHAPE
    assert torch.equal(a, b)
    I, p = frames.guide_ring(*SHAPE, BIG_SEED, "cpu")
    I2, p2 = frames.guide_ring(*SHAPE, BIG_SEED, "cpu")
    assert torch.equal(I, I2) and torch.equal(p, p2)


def test_two_seeds_give_two_rings():
    a = frames.scene_ring(*SHAPE, 1, "cpu")
    b = frames.scene_ring(*SHAPE, 2, "cpu")
    assert not torch.equal(a, b)
    I, p = frames.guide_ring(*SHAPE, 1, "cpu")
    I2, p2 = frames.guide_ring(*SHAPE, 2, "cpu")
    assert not torch.equal(I, I2) and not torch.equal(p, p2)


def test_frames_of_a_ring_differ():
    ring = frames.scene_ring(*SHAPE, 5, "cpu")
    for i in range(1, SHAPE[0]):
        assert not torch.equal(ring[0], ring[i])


def test_scenes_span_the_range_and_guides_lie_in_0_1():
    ring = frames.scene_ring(2, 270, 480, 9, "cpu")
    assert int(ring.min()) < 40 and int(ring.max()) > 200
    I, p = frames.guide_ring(2, 270, 480, 9, "cpu")
    for x in (I, p):
        assert x.dtype == torch.float32
        assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert 0.05 < float((p - I).abs().mean()) < 0.1
