"""`fidget_tpu_torch.render.config`'s `TileSizes` and `RenderHints`
against `fidget_tpu.render.config`'s, on the same inputs: the lists,
`last()`, the hints, and the `ValueError` types and messages."""

import pytest

from fidget_tpu.render import config as ref
from fidget_tpu_torch.render import config as port

GOOD = [[64], [64, 16], [256, 64, 8, 1], (128, 32), ["32", 8], [7.0]]
BAD = [[], [16, 64], [64, 64], [64, 24], [64, 16, 16], [3, 0]]


@pytest.mark.parametrize("sizes", GOOD)
def test_tile_sizes_equal(sizes):
    got, want = port.TileSizes(sizes), ref.TileSizes(sizes)
    assert isinstance(got, list) and got == want
    assert [type(v) for v in got] == [type(v) for v in want]
    assert got.last() == want.last()


@pytest.mark.parametrize("sizes", BAD)
def test_tile_sizes_errors_equal(sizes):
    with pytest.raises(Exception) as want:
        ref.TileSizes(sizes)
    with pytest.raises(Exception) as got:
        port.TileSizes(sizes)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_render_hints_equal():
    h, r = port.RenderHints, ref.RenderHints
    assert h.tile_sizes_2d() == r.tile_sizes_2d()
    assert h.tile_sizes_3d() == r.tile_sizes_3d()
    assert isinstance(h.tile_sizes_3d(), port.TileSizes)
    for depth in range(0, 12):
        assert (h.simplify_tree_during_meshing(depth)
                == r.simplify_tree_during_meshing(depth))
