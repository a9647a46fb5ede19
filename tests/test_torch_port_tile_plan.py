"""The bf16 kernel-4 tile planner (``ops/bottleneck.py:basic_tile_plan``),
the function the wrapper launches by: at every ResNet-18/34 fused stack
shape (and the GPU tests' ragged ones) its blocks fit in shared memory,
cover every output row and image exactly once, and stage a halo that
stays inside the image. CPU only: it checks arithmetic, no kernel."""

import pytest
import torch

from eov_tpu_torch.ops import bottleneck

SMEM = 232448  # bytes of shared memory one block may use on an H100
# (h = w, C): stage 1 and the stride-1 tails of stages 2-4 at 224^2; the
# same in ResNet-18 and ResNet-34.
RESNET_STACKS = [(56, 64), (28, 128), (14, 256), (7, 512)]


def _blocks_rows(plan, h):
    """The kernel's row tiles: block x owns rows [x tr, x tr + rows) and
    computes y1 over [lo, hi), staging x over [xlo, xhi)."""
    tr = plan["tile_rows"]
    for bx in range(plan["grid"][0]):
        r0 = bx * tr
        rows = min(tr, h - r0)
        lo, hi = max(r0 - 1, 0), min(r0 + rows + 1, h)
        yield r0, rows, lo, hi, max(lo - 1, 0), min(hi + 1, h)


@pytest.mark.parametrize("n", [1, 3, 256])
@pytest.mark.parametrize("hw,c", RESNET_STACKS)
def test_plan_fits_and_covers_resnet_stacks(hw, c, n):
    plan = bottleneck.basic_tile_plan(hw, hw, c, n)
    tr, g, cp, wn = (plan[k] for k in ("tile_rows", "images", "cp", "wn"))
    assert plan["smem"] <= SMEM
    assert cp == c and cp % (64 * wn) == 0
    assert plan["m_tile"] * wn == 8 * 64  # eight warps of 64 x 64
    assert g == 1 or tr == hw
    # Every image exactly once.
    gy = plan["grid"][1]
    assert (gy - 1) * g < n <= gy * g
    covered = []
    for r0, rows, lo, hi, xlo, xhi in _blocks_rows(plan, hw):
        assert rows >= 1
        covered += range(r0, r0 + rows)
        # The halo stays in the image and in the block's buffers.
        assert 0 <= xlo <= lo <= r0 and r0 + rows <= hi <= xhi <= hw
        assert hi - lo <= min(tr + 2, hw) and xhi - xlo <= min(tr + 4, hw)
        # y1 of the block (halo included) is one M pass of the warps.
        assert g * (hi - lo) * hw <= plan["m_tile"]
    assert covered == list(range(hw))


@pytest.mark.parametrize("hw,c,tr,g", [(56, 64, 7, 1), (28, 128, 7, 1),
                                       (14, 256, 7, 1), (7, 512, 7, 2)])
def test_plan_resnet34_tiles(hw, c, tr, g):
    """The tiles PERF.md records: 7 rows at every stack, two 7^2 images
    per block (98 of the 128 rows of its M tile)."""
    plan = bottleneck.basic_tile_plan(hw, hw, c, 256)
    assert (plan["tile_rows"], plan["images"]) == (tr, g)


@pytest.mark.parametrize("h,w,c,n", [(5, 7, 24, 3), (6, 10, 24, 9),
                                     (5, 7, 512, 3), (7, 7, 512, 5),
                                     (14, 14, 256, 3), (56, 3, 64, 3),
                                     (112, 112, 64, 2), (33, 41, 40, 2)])
def test_plan_ragged_shapes(h, w, c, n):
    """Channels padded to 64, rows and images covered, within shared
    memory, at the shapes the GPU tests and other input sizes give."""
    plan = bottleneck.basic_tile_plan(h, w, c, n)
    assert plan["smem"] <= SMEM and plan["cp"] >= c and plan["cp"] % 64 == 0
    gy = plan["grid"][1]
    assert (gy - 1) * plan["images"] < n <= gy * plan["images"]
    covered = [r for r0, rows, *_ in _blocks_rows(plan, h)
               for r in range(r0, r0 + rows)]
    assert covered == list(range(h))


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        bottleneck.basic_tile_plan(8, 400, 64)


@pytest.mark.parametrize("c,cp,nt", [(72, 128, 64), (256, 256, 256)])
def test_mma_weights_tile_order(c, cp, nt):
    """The relaid-out weights: tile (N pass, chunk, tap) is contiguous and
    K-major, [NT output channels][64 input channels], zero-padded to cp."""
    w9 = torch.arange(9 * c * c, dtype=torch.float32).reshape(9, c, c) + 1
    out = bottleneck._mma_weights(w9, cp, nt)
    assert out.shape == (cp // nt, cp // 64, 9, nt, 64)
    for npass in range(cp // nt):
        for chunk in range(cp // 64):
            for tap in range(9):
                tile = out[npass, chunk, tap]
                k = slice(64 * chunk, min(64 * chunk + 64, c))
                n = slice(nt * npass, min(nt * npass + nt, c))
                rows, cols = n.stop - n.start, k.stop - k.start
                assert torch.equal(tile[:rows, :cols], w9[tap, k, n].t())
                assert not tile[rows:].any() and not tile[:, cols:].any()
