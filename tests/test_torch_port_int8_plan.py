"""Kernel 7's tile planner (``ops/bottleneck_int8.py:int8_tile_plan``), its
shared-memory formula and weight relayout: the host-side arithmetic the
kernel launches by. CPU only: it checks arithmetic, no kernel."""

import numpy as np
import pytest
import torch

from eov_tpu_torch.ops import bottleneck_int8 as bi

SMEM = 232448  # bytes of shared memory one block may use on an H100
# (h, w, cin, cmid, cout, n): ResNet-50 stage 1's two block shapes at 256
# and 8 images, and every block shape the GPU tests launch (the entry
# block's, then the identity blocks' cin = cout).
GPU_SHAPES = [(56, 56, 64, 64, 256, 256), (56, 56, 256, 64, 256, 256),
              (56, 56, 64, 64, 256, 8), (56, 56, 256, 64, 256, 8),
              (6, 7, 16, 8, 32, 3), (6, 7, 32, 8, 32, 3),
              (5, 9, 32, 16, 32, 3), (3, 65, 24, 16, 40, 3),
              (3, 65, 40, 16, 40, 3), (9, 5, 64, 64, 256, 3),
              (9, 5, 256, 64, 256, 3), (14, 14, 64, 64, 256, 4),
              (14, 14, 256, 64, 256, 4), (30, 44, 256, 64, 256, 2),
              (13, 56, 256, 64, 256, 2), (13, 56, 64, 64, 256, 2),
              (14, 14, 64, 64, 256, 7), (14, 14, 256, 64, 256, 7),
              (5, 9, 20, 12, 36, 3), (5, 9, 36, 12, 36, 3),
              (4, 6, 21, 10, 33, 2), (4, 6, 33, 10, 33, 2)]


def _tiles(plan, h, n):
    """The kernel's blocks: (images, output rows [r0, r0 + rows), staged
    rows [lo, hi))."""
    tr, g = plan["tile_rows"], plan["images"]
    for gy in range(plan["grid"][1]):
        imgs = list(range(gy * g, min(gy * g + g, n)))
        for bx in range(plan["grid"][0]):
            r0 = bx * tr
            rows = min(tr, h - r0)
            yield imgs, r0, rows, max(r0 - 1, 0), min(r0 + rows + 1, h)


@pytest.mark.parametrize("h,w,cin,cmid,cout,n", GPU_SHAPES)
def test_int8_plan_fits_and_covers(h, w, cin, cmid, cout, n):
    plan = bi.int8_tile_plan(h, w, cin, cmid, cout, n)
    tr, g = plan["tile_rows"], plan["images"]
    assert plan["smem"] <= SMEM
    assert plan["smem"] == bi._int8_smem(
        h, w, plan["cinp"], plan["cmidp"], tr, g, plan["wn1"], plan["wn3"],
        cin != cout)
    for c, cp in ((cin, "cinp"), (cmid, "cmidp"), (cout, "coutp")):
        assert plan[cp] >= c and plan[cp] % 64 == 0 and plan[cp] - c < 64
    assert plan["wn1"] in (1, 2) and plan["cmidp"] % (64 * plan["wn1"]) == 0
    assert plan["wn3"] in (1, 2, 4) and plan["coutp"] % (64 * plan["wn3"]) == 0
    assert plan["m_tile"] * plan["wn1"] == 512
    assert g == 1 or tr == h
    seen = {}
    for imgs, r0, rows, lo, hi in _tiles(plan, h, n):
        assert rows >= 1 and imgs
        # The staged rows hold the tile and its in-image halo, and fit the
        # buffers' min(TR + 2, h) rows.
        assert 0 <= lo <= r0 and r0 + rows <= hi <= h
        assert hi - lo <= min(tr + 2, h)
        for i in imgs:
            seen.setdefault(i, []).extend(range(r0, r0 + rows))
    assert sorted(seen) == list(range(n))
    assert all(v == list(range(h)) for v in seen.values())


@pytest.mark.parametrize("cin", [64, 256])
def test_int8_plan_resnet50_stage1_halo(cin):
    """At 56^2 the int8 tiles hold at least 8 rows: the staged halo (TR +
    2) / TR is at most 1.25 (the dp4a kernel's 2 rows: 2.0)."""
    plan = bi.int8_tile_plan(56, 56, cin, 64, 256, 256)
    assert plan["tile_rows"] >= 8
    assert plan["halo"] <= 1.25
    assert plan["halo"] == (plan["tile_rows"] + 2) / plan["tile_rows"]
    assert plan["images"] == 1
    assert plan["grid"] == (-(-56 // plan["tile_rows"]), 256)


def test_int8_smem_hand_count():
    """The formula against a count by hand: 56^2, TR 8, cin 256 (entry
    block: cin 64 and the projection's tile)."""
    ring = 3 * 64 * 64            # three [64][64] int8 weight tiles
    x = 10 * 56 * 256             # 10 staged rows at 256 channels
    y1 = 10 * 56 * 64
    assert bi._int8_smem(56, 56, 256, 64, 8, 1, 1, 1, False) == \
        ring + 128 + x + y1
    # Entry block, N passes of 256: the ring's tiles are [256][64]; y2 (8
    # rows x 64) fits in x's place (10 rows x 64); xd is the output rows
    # at cin's 64 channels.
    x, y1, xd = 10 * 56 * 64, 10 * 56 * 64, 8 * 56 * 64
    assert bi._int8_smem(56, 56, 64, 64, 8, 1, 1, 4, True) == \
        3 * 256 * 64 + 128 + x + y1 + xd
    # y2 outgrows x when cmid > cin (cin 64, cmid 128, 2 images of 4 x 4).
    assert bi._int8_smem(4, 4, 64, 128, 4, 2, 2, 1, True) == \
        3 * 128 * 64 + 128 + 2 * 16 * 128 + 2 * 16 * 128 + 2 * 16 * 64


@pytest.mark.parametrize("cin", [64, 256])
def test_int8_plan_takes_least_cost(cin):
    """No fitting tiling of ResNet-50 stage 1 costs less per image than the
    plan's (K steps plus bytes at _STEP_BYTES a step)."""
    h = w = 56
    proj = cin != 256
    plan = bi.int8_tile_plan(h, w, cin, 64, 256, 256)
    for wn3 in (1, 2, 4):
        for tr in range(1, h + 1):
            if bi._int8_smem(h, w, cin, 64, tr, 1, 1, wn3, proj) > SMEM:
                break
            _, cost = bi._int8_cost(h, w, cin, 64, 256, proj, tr, 1, 1, wn3)
            assert cost >= plan["cost"] - 1e-9
    steps, cost = bi._int8_cost(h, w, cin, 64, 256, proj, plan["tile_rows"],
                                1, plan["wn1"], plan["wn3"])
    assert (steps, cost) == (plan["steps"], plan["cost"])


def test_int8_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        bi.int8_tile_plan(4, 2000, 512, 64, 512, 1)


def _unpack_tiles(t, k, n):
    """[N/nt, K/64, nt, 64] -> [K, N] (the inverse of _kmajor_tiles)."""
    return t.permute(1, 3, 0, 2).reshape(k, n)


@pytest.mark.parametrize("cin,cmid,cout,proj", [
    (64, 64, 256, True), (256, 64, 256, False), (24, 16, 40, True),
    (16, 8, 32, True), (40, 8, 40, False)])
def test_int8_weights_invert_to_packed(cin, cmid, cout, proj):
    """The kernel's weight relayout, undone, gives back
    pack_bottleneck_params_int8's arrays element for element, and zeros in
    the padding."""
    rng = np.random.default_rng(cin + cmid + cout)

    def wq(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))

    b = {"w1": wq(cin, cmid), "w2": wq(9, cmid, cmid), "w3": wq(cmid, cout)}
    if proj:
        b["wd"] = wq(cin, cout)
    plan = bi.int8_tile_plan(14, 14, cin, cmid, cout, 2, proj)
    cinp, cmidp, coutp = plan["cinp"], plan["cmidp"], plan["coutp"]
    nt1, nt3 = 64 * plan["wn1"], 64 * plan["wn3"]
    w1t, w2t, w3t = bi._int8_mma_weights(b, plan)
    assert w1t.dtype == torch.int8 and w1t.is_contiguous()
    assert tuple(w1t.shape) == (cmidp // nt1, cinp // 64, nt1, 64)
    assert tuple(w2t.shape) == (cmidp // nt1, cmidp // 64, 9, nt1, 64)
    kc = cmidp // 64 + (cinp // 64 if proj else 0)
    assert tuple(w3t.shape) == (coutp // nt3, kc, nt3, 64)
    w1 = _unpack_tiles(w1t, cinp, cmidp)
    assert torch.equal(w1[:cin, :cmid], b["w1"])
    assert not w1[cin:].any() and not w1[:, cmid:].any()
    # w2: tile (np, ch, tap) row n, column k = w2[tap, 64 ch + k, np nt1 + n].
    w2 = w2t.permute(2, 1, 4, 0, 3).reshape(9, cmidp, cmidp)
    assert torch.equal(w2[:, :cmid, :cmid], b["w2"])
    assert not w2[:, cmid:].any() and not w2[:, :, cmid:].any()
    w3 = _unpack_tiles(w3t, kc * 64, coutp)
    if proj:  # the projection's K steps come first
        wd, w3 = w3[:cinp], w3[cinp:]
        assert torch.equal(wd[:cin, :cout], b["wd"])
        assert not wd[cin:].any() and not wd[:, cout:].any()
    assert torch.equal(w3[:cmid, :cout], b["w3"])
    assert not w3[cmid:].any() and not w3[:, cout:].any()
