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


# ------------------------------------------------ kernel 2 (and 5) in bf16

# (h = w, cin, cmid, cout) of the ResNet-50 blocks kernel 2 runs at 224^2:
# stage 1's entry block (projection) and its tail, and the stride-1 tails
# of stages 2-4 (extract --fused-stages 1,2,3,4).
RESNET50_BLOCKS = [(56, 64, 64, 256), (56, 256, 64, 256), (28, 512, 128, 512),
                   (14, 1024, 256, 1024), (7, 2048, 512, 2048)]


def _bottleneck_tiles(plan, h):
    """The kernel's row tiles: block x owns output rows [x tr, x tr + rows)
    and computes y1 over (and stages x for) [lo, hi)."""
    tr = plan["tile_rows"]
    for bx in range(plan["grid"][0]):
        r0 = bx * tr
        rows = min(tr, h - r0)
        yield r0, rows, max(r0 - 1, 0), min(r0 + rows + 1, h)


def _check_bottleneck_plan(plan, h, w, cin, cmid, cout, n):
    tr, g = plan["tile_rows"], plan["images"]
    assert plan["smem"] <= SMEM
    assert plan["smem"] == bottleneck._bottleneck_smem(
        h, w, plan["cinp"], plan["cmidp"], tr, g, plan["wn1"], plan["wn3"])
    for c, cp in ((cin, "cinp"), (cmid, "cmidp"), (cout, "coutp")):
        assert plan[cp] >= c and plan[cp] % 64 == 0 and plan[cp] - c < 64
    assert plan["cmidp"] % (64 * plan["wn1"]) == 0
    assert plan["coutp"] % (64 * plan["wn3"]) == 0
    assert plan["m_tile"] * plan["wn1"] == 512
    assert plan["m_tile_out"] * plan["wn3"] == 512
    assert g == 1 or tr == h
    # y2 takes y1's place only when phase B is one M pass and one N pass.
    if plan["overlay"]:
        assert plan["cmidp"] == 64 * plan["wn1"]
        assert g * tr * w <= plan["m_tile"]
    # Every image exactly once.
    gy = plan["grid"][1]
    assert (gy - 1) * g < n <= gy * g
    covered = []
    for r0, rows, lo, hi in _bottleneck_tiles(plan, h):
        assert rows >= 1
        covered += range(r0, r0 + rows)
        # The halo stays in the image and in the block's buffers.
        assert 0 <= lo <= r0 and r0 + rows <= hi <= h
        assert hi - lo <= min(tr + 2, h)
    assert covered == list(range(h))


@pytest.mark.parametrize("n", [1, 3, 256])
@pytest.mark.parametrize("hw,cin,cmid,cout", RESNET50_BLOCKS)
def test_bottleneck_plan_fits_and_covers_resnet50(hw, cin, cmid, cout, n):
    plan = bottleneck.bottleneck_tile_plan(hw, hw, cin, cmid, cout, n)
    _check_bottleneck_plan(plan, hw, hw, cin, cmid, cout, n)


@pytest.mark.parametrize("h,w,cin,cmid,cout,n", [
    (14, 14, 40, 72, 136, 3), (5, 7, 24, 16, 40, 3), (6, 10, 24, 16, 40, 9),
    (5, 5, 24, 16, 40, 2), (6, 7, 64, 16, 40, 2), (56, 56, 64, 64, 256, 1),
    (33, 41, 40, 72, 136, 2), (56, 3, 64, 64, 256, 3),
    (9, 5, 136, 72, 136, 4)])
def test_bottleneck_plan_ragged_shapes(h, w, cin, cmid, cout, n):
    """Channels padded to 64, rows and images covered, within shared
    memory, at the shapes the GPU tests and other input sizes give."""
    plan = bottleneck.bottleneck_tile_plan(h, w, cin, cmid, cout, n)
    _check_bottleneck_plan(plan, h, w, cin, cmid, cout, n)


def _stage1_entry_steps(tr, wn3):
    """K steps per image of ResNet-50 stage 1's entry block (56^2, 64 ->
    64 -> 256 with projection; conv1 and conv2 in 512-row M passes of 64
    channels) at tr-row tiles, counted tile by tile: conv1 one step per M
    pass, conv2 nine, conv3 two (w3 and wd) per M pass and N pass."""
    steps = 0
    for r0 in range(0, 56, tr):
        rows = min(tr, 56 - r0)
        halo = min(r0 + rows + 1, 56) - max(r0 - 1, 0)
        steps += -(-halo * 56 // 512) + 9 * -(-rows * 56 // 512) \
            + 2 * -(-rows * 56 // (512 // wn3)) * (4 // wn3)
    return steps


def test_bottleneck_plan_takes_fewest_steps():
    """At ResNet-50 stage 1's entry block the plan counts its K steps as
    an independent count does, and takes no more than 7-row tiles (8
    tiles of 1 + 9 + 8 steps) or any other height."""
    plan = bottleneck.bottleneck_tile_plan(56, 56, 64, 64, 256, 256)
    assert plan["wn1"] == 1 and plan["overlay"] and plan["images"] == 1
    assert plan["steps"] == _stage1_entry_steps(plan["tile_rows"],
                                                plan["wn3"])
    assert _stage1_entry_steps(7, 1) == 8 * (1 + 9 + 8)
    fits = [(tr, wn3) for tr in range(1, 57) for wn3 in (1, 2, 4)
            if bottleneck._bottleneck_smem(56, 56, 64, 64, tr, 1, 1, wn3)
            <= SMEM]
    assert plan["steps"] == min(_stage1_entry_steps(*c) for c in fits)


def test_bottleneck_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        bottleneck.bottleneck_tile_plan(8, 600, 64, 64, 256)


def _pack(cin, cmid, cout, proj, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = {"w1": torch.randn(cin, cmid, generator=g),
         "w2": torch.randn(9, cmid, cmid, generator=g),
         "w3": torch.randn(cmid, cout, generator=g)}
    if proj:
        b["wd"] = torch.randn(cin, cout, generator=g)
    return b


@pytest.mark.parametrize("hw,cin,cmid,cout,proj", [
    (56, 64, 64, 256, True), (28, 512, 128, 512, False),
    (14, 40, 72, 136, True), (5, 24, 16, 40, True)])
def test_bottleneck_mma_weights_tile_order(hw, cin, cmid, cout, proj):
    """The relaid-out weights, read back tile by tile: w1's (N pass, chunk)
    tile, w2's (N pass, chunk, tap) tile and w3's (N pass, K chunk) tile
    (wd's chunks after w3's) are [NT output channels][64 input channels],
    zero-padded to the plan's channel counts."""
    b = _pack(cin, cmid, cout, proj)
    plan = bottleneck.bottleneck_tile_plan(hw, hw, cin, cmid, cout, 2)
    nt1, nt3 = 64 * plan["wn1"], 64 * plan["wn3"]
    kin, kmid = plan["cinp"] // 64, plan["cmidp"] // 64
    w1t, w2t, w3t = bottleneck._bottleneck_mma_weights(b, plan)
    assert w1t.shape == (plan["cmidp"] // nt1, kin, nt1, 64)
    assert w2t.shape == (plan["cmidp"] // nt1, kmid, 9, nt1, 64)
    assert w3t.shape == (plan["coutp"] // nt3, kmid + (kin if proj else 0),
                         nt3, 64)

    def read_back(tiles, k, n, nt, taps=None):
        """[N passes][K chunks](taps)[nt][64] -> the [K, N] (or [9, K, N])
        weight, with the padding checked to be zero."""
        full = tiles.movedim(-1, -2)  # [..., 64 (k), nt (n)]
        if taps is None:
            full = full.permute(1, 2, 0, 3).reshape(full.shape[1] * 64, -1)
        else:
            full = full.permute(2, 1, 3, 0, 4).reshape(
                9, full.shape[1] * 64, -1)
        assert not full[..., k:, :].any() and not full[..., :, n:].any()
        return full[..., :k, :n]

    assert torch.equal(read_back(w1t, cin, cmid, nt1), b["w1"])
    assert torch.equal(read_back(w2t, cmid, cmid, nt1, taps=9), b["w2"])
    k3 = read_back(w3t[:, :kmid], cmid, cout, nt3)
    assert torch.equal(k3, b["w3"])
    if proj:
        assert torch.equal(read_back(w3t[:, kmid:], cin, cout, nt3), b["wd"])


def test_bottleneck_plain_stream_max():
    """``stream_max=True`` returns the same output and, per pixel, the
    largest |x| over the channels of the input and of every block's
    output, broadcast over the output's channels."""
    g = torch.Generator().manual_seed(1)
    blocks = []
    for cin in (8, 24):
        b = _pack(cin, 16, 24, cin != 24, seed=cin)
        b = {k: v * 0.2 for k, v in b.items()}
        b.update(b1=torch.zeros(16), b2=torch.zeros(16), b3=torch.zeros(24))
        if "wd" in b:
            b["bd"] = torch.zeros(24)
        blocks.append(b)
    x = torch.randn(2, 5 * 6, 8, generator=g).relu()
    plain = bottleneck.bottleneck_stack_plain(x, blocks, h=5, w=6)
    out, top = bottleneck.bottleneck_stack_plain(x, blocks, h=5, w=6,
                                                 stream_max=True)
    assert torch.equal(out, plain) and top.shape == out.shape
    mid = bottleneck.bottleneck_stack_plain(x, blocks[:1], h=5, w=6)
    want = torch.stack([t.abs().amax(-1) for t in (x, mid, out)]).amax(0)
    assert torch.equal(top[..., 0], want) and torch.equal(top[..., 5], want)
