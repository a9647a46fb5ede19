"""The bf16 tile planners of kernels 8 and 9 (``ops/bottleneck_train.py``:
``train_tile_plan`` for the forward and the input-gradient pass,
``train_wgrad_plan`` for the weight gradients) and their weight relayouts,
on the CPU: every block fits the shared memory and covers its rows,
images and pixels exactly once at the train path's shapes and the GPU
tests' ragged ones; the planners' shared memory is the kernels' formula
(mirrored here); what does not fit is refused; each relaid-out weight
puts every element where the kernel reads it. No kernel runs here."""

import numpy as np
import pytest
import torch

from eov_tpu_torch.ops import bottleneck
from eov_tpu_torch.ops import bottleneck_train as bt

SMEM = 232448  # bytes of shared memory one block may use on an H100
# (h, w, cin, cmid, cout, projected entry): the train path's two stacks
# (ResNet-50 stage 1 and the stride-1 tail of stage 2), each block, and
# the GPU tests' shapes (ragged channels, h != w, w = 65).
TRAIN_BLOCKS = [(56, 56, 64, 64, 256, True), (56, 56, 256, 64, 256, False),
                (28, 28, 512, 128, 512, False)]
RAGGED_BLOCKS = [(6, 7, 16, 8, 32, True), (6, 7, 32, 8, 32, False),
                 (9, 5, 64, 64, 256, True), (7, 10, 128, 128, 128, False),
                 (3, 65, 24, 16, 40, True), (3, 65, 40, 16, 40, False),
                 (14, 14, 64, 64, 256, True)]


def _mma_smem(h, w, cinp, cmidp, tr, g, wn1, wn3, mrows):
    """The three-phase block's shared memory, from its layout: a 3-deep
    ring of [64 max(wn1, wn3)][64] bf16 weight tiles, a 128-byte zero
    line, one (cin <= 64) or two 64-channel input chunks of the block's
    rows and halo, y1 over them at all of cmid's channels, and y2 unless
    it takes y1's place (one M pass of mrows / wn1 rows and one N pass of
    phase B)."""
    yrows = min(tr + 2, h)
    ring = 3 * 64 * 64 * 2 * max(wn1, wn3)
    xbuf = (2 if cinp > 64 else 1) * g * yrows * w * 64 * 2
    y1 = g * yrows * w * cmidp * 2
    one_pass = cmidp == 64 * wn1 and g * tr * w <= mrows // wn1
    y2 = 0 if one_pass else g * tr * w * cmidp * 2
    return ring + 128 + xbuf + y1 + y2


def _check_tile_plan(plan, h, w, cin, cmid, cout, n):
    tr, g = plan["tile_rows"], plan["images"]
    assert plan["smem"] <= SMEM
    assert plan["smem"] == _mma_smem(h, w, plan["cinp"], plan["cmidp"], tr,
                                     g, plan["wn1"], plan["wn3"],
                                     plan["mrows"])
    assert plan["m_tile"] * plan["wn1"] == plan["mrows"]
    assert plan["m_tile_out"] * plan["wn3"] == plan["mrows"]
    for c, key in ((cin, "cinp"), (cmid, "cmidp"), (cout, "coutp")):
        assert plan[key] >= c and plan[key] % 64 == 0 and plan[key] - c < 64
    assert plan["cmidp"] % (64 * plan["wn1"]) == 0
    assert plan["coutp"] % (64 * plan["wn3"]) == 0
    assert g == 1 or tr == h
    gx, gy = plan["grid"]
    assert (gy - 1) * g < n <= gy * g
    rows = [r for bx in range(gx) for r in range(bx * tr, min(bx * tr + tr,
                                                              h))]
    assert rows == list(range(h))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n", [1, 3, 96])
@pytest.mark.parametrize("h,w,cin,cmid,cout,proj",
                         TRAIN_BLOCKS + RAGGED_BLOCKS)
def test_train_plan_fits_and_covers(h, w, cin, cmid, cout, proj, n,
                                    backward):
    """Kernel 8's plan, and kernel 9's input-gradient plan (the block run
    backwards: cout channels in, cin out), fit and cover the map."""
    plan = bt.train_tile_plan(h, w, cin, cmid, cout, n, backward=backward)
    # The forward's promoted sums take half kernel 2's M pass.
    assert plan["mrows"] == (512 if backward else 256)
    if backward:
        cin, cout = cout, cin
    _check_tile_plan(plan, h, w, cin, cmid, cout, n)


def test_train_plan_at_the_train_shapes():
    """The train path's entry block at 96 images: the forward is kernel
    2's planner at 256-row M passes, the input gradient kernel 2's own
    plan of the block run backwards."""
    fwd = bt.train_tile_plan(56, 56, 64, 64, 256, 96)
    assert {k: v for k, v in fwd.items() if k != "mrows"} == \
        bottleneck.bottleneck_tile_plan(56, 56, 64, 64, 256, 96, 256)
    assert fwd["m_tile"] == 256
    bwd = bt.train_tile_plan(56, 56, 64, 64, 256, 96, backward=True)
    assert {k: v for k, v in bwd.items() if k != "mrows"} == \
        bottleneck.bottleneck_tile_plan(56, 56, 256, 64, 64, 96)
    assert (bwd["cinp"], bwd["coutp"]) == (256, 64)


def test_train_plan_refuses():
    with pytest.raises(ValueError, match="shared memory"):
        bt.train_tile_plan(8, 600, 64, 64, 256)
    with pytest.raises(ValueError, match="multiples of 8"):
        bt.train_tile_plan(8, 8, 20, 64, 256)
    with pytest.raises(ValueError, match="multiples of 8"):
        bt.train_wgrad_plan(8, 8, 64, 36, 2, 1)
    with pytest.raises(ValueError, match="shared memory"):
        bt.train_wgrad_plan(4, 300, 64, 64, 2, 9)
    with pytest.raises(ValueError, match="1 or 9 taps"):
        bt.train_wgrad_plan(4, 4, 64, 64, 2, 3)


def _wgrad_smem(k3, knb, w, rows):
    """The weight-gradient block's shared memory, from its layout: two
    buffers, each an A range (a 3x3's rows with their halo rows, else 128
    pixels; 64 channels; 1024-byte aligned) and knb 64-channel G chunks of
    the range's pixels padded to 16; a 128-byte zero line."""
    a_px = (rows + 2) * w if k3 else 128
    g_px = -(-rows * w // 16) * 16 if k3 else 128
    a = -(-a_px * 128 // 1024) * 1024
    return 2 * (a + knb * g_px * 128) + 128


WGRADS = [(h, w, ka, ng, taps)
          for h, w, cin, cmid, cout, proj in TRAIN_BLOCKS + RAGGED_BLOCKS
          for ka, ng, taps in [(cmid, cout, 1), (cmid, cmid, 9),
                               (cin, cmid, 1)] + ([(cin, cout, 1)]
                                                  if proj else [])]


@pytest.mark.parametrize("n", [1, 3, 96])
@pytest.mark.parametrize("h,w,ka,ng,taps", WGRADS)
def test_wgrad_plan_fits_and_partitions(h, w, ka, ng, taps, n):
    """Every pixel in exactly one range, every range in exactly one slot,
    every (A chunk, G chunk group) in one tile; within shared memory."""
    plan = bt.train_wgrad_plan(h, w, ka, ng, n, taps)
    k3 = taps == 9
    assert plan["smem"] <= SMEM
    assert plan["smem"] == _wgrad_smem(k3, plan["knb"], w, plan["rows"])
    assert 1 <= plan["slots"] <= plan["ranges"]
    assert plan["grid"] == (plan["slots"], plan["tiles"])
    assert plan["tiles"] == -(-ka // 64) * -(-ng // (64 * plan["knb"]))
    assert plan["part"] == plan["slots"] * taps * ka * ng
    if k3:
        rows = plan["rows"]
        per_img = -(-h // rows)
        assert plan["ranges"] == n * per_img
        covered = [r for t in range(per_img)
                   for r in range(t * rows, min(t * rows + rows, h))]
        assert covered == list(range(h))
        # The range and its halo rows fit the staged buffer.
        assert (rows + 2) * w * 128 <= plan["smem"] // 2
    else:
        assert plan["ranges"] == -(-n * h * w // 128)
    taken = sorted(r for s in range(plan["slots"])
                   for r in range(s, plan["ranges"], plan["slots"]))
    assert taken == list(range(plan["ranges"]))


def test_wgrad_plan_is_a_function_of_the_shapes():
    """The partition (and so the order dW is summed in) depends on the
    shapes only: the same call gives the same plan."""
    a = bt.train_wgrad_plan(56, 56, 64, 64, 96, 9)
    assert a == bt.train_wgrad_plan(56, 56, 64, 64, 96, 9)
    assert a["slots"] > 132  # more blocks than the card has SMs


def _block(cin, cmid, cout, proj, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = {"w1": torch.randn(cin, cmid, generator=g),
         "w2": torch.randn(9, cmid, cmid, generator=g),
         "w3": torch.randn(cmid, cout, generator=g)}
    if proj:
        b["wd"] = torch.randn(cin, cout, generator=g)
    return b


def _read_back(tiles, k, n, taps=False):
    """[N passes][K chunks](taps)[nt][64] -> the [K, N] (or [9, K, N])
    weight the tiles hold, the padding checked to be zero."""
    full = tiles.movedim(-1, -2)  # [..., 64 (k), nt (n)]
    if taps:
        full = full.permute(2, 1, 3, 0, 4).reshape(9, full.shape[1] * 64, -1)
    else:
        full = full.permute(1, 2, 0, 3).reshape(full.shape[1] * 64, -1)
    assert not full[..., k:, :].any() and not full[..., :, n:].any()
    return full[..., :k, :n]


@pytest.mark.parametrize("h,w,cin,cmid,cout,proj",
                         TRAIN_BLOCKS + RAGGED_BLOCKS)
def test_fwd_weights_where_kernel_8_reads_them(h, w, cin, cmid, cout, proj):
    """Kernel 8's tiles: w1 and w2 as kernel 2's, w3 alone (no wd chunks
    after it) and wd in tiles of its own, all [NT out][64 in] K-major."""
    b = _block(cin, cmid, cout, proj)
    plan = bt.train_tile_plan(h, w, cin, cmid, cout, 2)
    nt1, nt3 = 64 * plan["wn1"], 64 * plan["wn3"]
    w1t, w2t, w3t, wdt = bt._train_fwd_weights(b, plan)
    kin, kmid = plan["cinp"] // 64, plan["cmidp"] // 64
    assert w3t.shape == (plan["coutp"] // nt3, kmid, nt3, 64)
    assert torch.equal(_read_back(w1t, cin, cmid), b["w1"])
    assert torch.equal(_read_back(w2t, cmid, cmid, taps=True), b["w2"])
    assert torch.equal(_read_back(w3t, cmid, cout), b["w3"])
    if proj:
        assert wdt.shape == (plan["coutp"] // nt3, kin, nt3, 64)
        assert torch.equal(_read_back(wdt, cin, cout), b["wd"])
    else:
        assert wdt is None
    assert nt1 * (plan["cmidp"] // nt1) == plan["cmidp"]


@pytest.mark.parametrize("h,w,cin,cmid,cout,proj",
                         TRAIN_BLOCKS + RAGGED_BLOCKS)
def test_dgrad_weights_where_kernel_9_reads_them(h, w, cin, cmid, cout,
                                                 proj):
    """Kernel 9's input-gradient tiles: phase A's B[n = cm][k = co] =
    w3[cm, co] (w3^T as a [K, N] weight), phase B's tap t B[n = ci][k =
    co] = w2[8 - t, ci, co], phase C's K = w1^T's chunks then wd^T's."""
    b = _block(cin, cmid, cout, proj)
    plan = bt.train_tile_plan(h, w, cin, cmid, cout, 2, backward=True)
    wa, wb, wc = bt._train_dgrad_weights(b, plan)
    kmid = plan["cmidp"] // 64
    assert torch.equal(_read_back(wa, cout, cmid), b["w3"].t())
    flipped = _read_back(wb, cmid, cmid, taps=True)  # [t][k = co][n = ci]
    for t in range(9):
        assert torch.equal(flipped[t].t(), b["w2"][8 - t])
    assert torch.equal(_read_back(wc[:, :kmid], cmid, cin), b["w1"].t())
    if proj:
        assert torch.equal(_read_back(wc[:, kmid:], cout, cin), b["wd"].t())
    else:
        assert wc.shape[1] == kmid


def _shift(m, dy, dx):
    """m [H, W, C] read at (y + dy, x + dx), zero outside."""
    out = np.zeros_like(m)
    h, w = m.shape[:2]
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0),
                                                      h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0),
                                                      w + min(-dx, 0))
    out[yd, xd] = m[ys, xs]
    return out


@pytest.mark.parametrize("h,w,cmid", [(5, 7, 16), (6, 5, 72), (3, 65, 8)])
def test_flipped_taps_give_the_transposed_conv(h, w, cmid):
    """The input-gradient pass's 3x3: the forward's tap reads (pixel (y +
    ky - 1, x + kx - 1) for tap t = 3 ky + kx) times the relaid-out
    flipped weights equal the plain version's transposed 3x3 (the mirrored
    reads times w2[t]^T)."""
    b = _block(8, cmid, 16, False, seed=cmid)
    plan = bt.train_tile_plan(h, w, 8, cmid, 16, 1, backward=True)
    wb = _read_back(bt._train_dgrad_weights(b, plan)[1], cmid, cmid,
                    taps=True).numpy()  # [t][k][n]
    g2 = np.random.default_rng(h).standard_normal((h, w, cmid))
    got = sum(_shift(g2, t // 3 - 1, t % 3 - 1) @ wb[t] for t in range(9))
    gt = torch.from_numpy(g2.reshape(1, h * w, cmid))
    want = sum(tap[0].numpy() @ b["w2"][t].double().numpy().T
               for t, tap in enumerate(bt._taps(gt, h, w, -1)))
    np.testing.assert_allclose(got.reshape(h * w, cmid), want, rtol=1e-12,
                               atol=1e-10)
