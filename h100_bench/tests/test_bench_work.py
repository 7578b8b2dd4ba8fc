"""The operation and byte counts behind the rooflines and mfu shares."""

import pytest

from h100_bench.metrics import _work


def test_lenet_flops():
    assert _work.lenet_forward_flops(15) == 83_042_000
    assert _work.lenet_forward_flops(3) == 45_410_000
    assert _work.lenet_train_flops(15) == 3 * 83_042_000


@pytest.mark.parametrize("channels", [3, 15])
def test_counts_do_not_depend_on_chunking(channels):
    """A request's bytes are those of its hands and neighbourhoods: one
    launch of 1536 hands or three of 512 (or 4096 padded ones holding the
    same valid hands) count the same."""
    hands = [700, 512, 321]
    pts = [700 * 900, 512 * 1100, 321 * 1500]
    whole = _work.raster_bytes(channels, 60, sum(hands), sum(pts))
    parts = sum(_work.raster_bytes(channels, 60, h, p)
                for h, p in zip(hands, pts))
    assert whole == parts
    flops = sum(hands) * _work.lenet_forward_flops(channels)
    assert flops == sum(h * _work.lenet_forward_flops(channels)
                        for h in hands)


def test_roofline_share():
    # 3.35 GB at 3.35 TB/s take 1 ms: 1 ms of kernel time is 100%.
    assert _work.roofline_share(3.35e9, 1e-3) == pytest.approx(100.0)
