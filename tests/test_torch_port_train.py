"""The port's train path against the JAX reference on the CPU: PRNG draws,
train augmentation, the frozen-BN train stack (forward, backward, autograd),
the train-mode ResNet, the optimizer policy and whole train steps.

Inputs come from numpy seeds; weights cross over with
``from_jax_variables``. The reference's Pallas train kernels run in
interpret mode; the port's ops take their plain versions (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import eov_tpu.ops.pallas_bottleneck_train as jbt
from eov_tpu import train as jtr
from eov_tpu.models import get_arch as j_get_arch
from eov_tpu.ops import preprocess as jpre

from eov_tpu_torch import prng
from eov_tpu_torch import train as ttr
from eov_tpu_torch.models.resnet import ResNet, from_jax_variables
from eov_tpu_torch.ops import bottleneck_train as tbt
from eov_tpu_torch.ops import preprocess as tpre

SEEDS = [0, 1, 7, 42, 12345, 2**31 - 1]


# ------------------------------------------------------------------ prng

@pytest.mark.parametrize("lo,hi", [(0, 10), (0, 13), (3, 17), (-5, 7),
                                   (0, 1), (4, 4), (9, 2), (0, 70_001),
                                   (-2**31, 2**31 - 1)])
def test_randint_bitwise(lo, hi):
    """Bitwise over many keys and spans (odd and power-free ones, empty
    ranges, spans past 2^16 where the multiplier wraps uint32)."""
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (9,), lo, hi))(keys))
    got = prng.randint(torch.stack([prng.key(s) for s in SEEDS]), (9,), lo,
                       hi)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_bernoulli_bitwise():
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    for p in (0.5, 0.1, 0.9):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.bernoulli(k, p))(keys))
        got = prng.bernoulli(prng.split(prng.key(3), 64), p)
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 64


# ------------------------------------------------------------ preprocess

@pytest.mark.parametrize("name", ["preprocess_train",
                                  "preprocess_train_multiscale"])
@pytest.mark.parametrize("h,w", [(40, 48), (50, 36), (36, 36)])
def test_train_augment_matches_reference(name, h, w):
    """Batched augmentation == the reference vmapped over
    jax.random.split keys, f32, atol 1e-4 (the same draws: bit-exact
    keys; only the resize sums round differently)."""
    frames = np.random.default_rng(h * w).integers(
        0, 256, (6, 2, h, w, 3), dtype=np.uint8)
    for seed in (0, 5):
        want = np.asarray(jax.vmap(lambda k, c: getattr(jpre, name)(
            k, c, scale_size=36, crop_size=32))(
            jax.random.split(jax.random.PRNGKey(seed), 6),
            jnp.asarray(frames)))
        got = getattr(tpre, name)(prng.split(prng.key(seed), 6),
                                  torch.from_numpy(frames), scale_size=36,
                                  crop_size=32).numpy()
        assert got.shape == want.shape == (6, 2, 32, 32, 3)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_multiscale_tables_match_reference():
    for h, w in ((256, 320), (36, 48)):
        ours = tpre._ms_weight_tables(h, w, 224 if h > 200 else 32)
        ref = jpre._ms_weight_tables(h, w, 224 if h > 200 else 32)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------- the train stack

def _mk_block(rng, cin, cmid, cout, proj):
    b = {"w1": rng.normal(0, 0.2, (cin, cmid)),
         "w2": rng.normal(0, 0.2, (9, cmid, cmid)),
         "w3": rng.normal(0, 0.2, (cmid, cout)),
         "s1": rng.normal(1, 0.1, cmid), "b1": rng.normal(0, 0.1, cmid),
         "s2": rng.normal(1, 0.1, cmid), "b2": rng.normal(0, 0.1, cmid),
         "s3": rng.normal(1, 0.1, cout), "b3": rng.normal(0, 0.1, cout)}
    if proj:
        b.update(wd=rng.normal(0, 0.2, (cin, cout)),
                 sd=rng.normal(1, 0.1, cout), bd=rng.normal(0, 0.1, cout))
    return {k: v.astype(np.float32) for k, v in b.items()}


def _stack_fixture(seed=0, n=3, h=6, w=7, cin=16, cmid=8, cout=32):
    """The reference's own fixture (tests/test_train_fused.py): h != w, so
    an off-by-one in the transposed 3x3's mirrored taps shows."""
    rng = np.random.default_rng(seed)
    blocks = [_mk_block(rng, cin, cmid, cout, True),
              _mk_block(rng, cout, cmid, cout, False)]
    x = rng.normal(0, 1, (n, h * w, cin)).astype(np.float32)
    dy = rng.normal(0, 1, (n, h * w, cout)).astype(np.float32)
    return x, dy, blocks, h, w


def _j(blocks):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in blocks]


def _t(blocks):
    return [{k: torch.from_numpy(v.copy()) for k, v in b.items()}
            for b in blocks]


STACK_DTYPES = [(jnp.float32, torch.float32, 1e-5, 1e-4),
                (jnp.bfloat16, torch.bfloat16, 1e-5, 1e-4)]


@pytest.mark.parametrize("jdt,tdt,tol_x,tol_w", STACK_DTYPES)
def test_stack_forward_backward_match_reference(jdt, tdt, tol_x, tol_w):
    """Plain forward/backward == _stack_forward_ref/_bwd_ref: f32 and bf16
    (same rounding points, so bf16 holds the same tolerance), rtol/atol
    1e-5 on y and dx, 1e-4 on the dW sums."""
    x, dy, blocks, h, w = _stack_fixture()
    want = np.asarray(jbt._stack_forward_ref(jnp.asarray(x), _j(blocks),
                                             h=h, w=w, dtype=jdt))
    got = tbt.train_stack_forward(torch.from_numpy(x), _t(blocks), h=h, w=w,
                                  dtype=tdt).numpy()
    np.testing.assert_allclose(got, want, rtol=tol_x, atol=tol_x)
    dxr, dwr = jbt._bwd_ref(jnp.asarray(x), _j(blocks), jnp.asarray(dy),
                            h=h, w=w, dtype=jdt)
    dxt, dwt = tbt.train_stack_backward(torch.from_numpy(x), _t(blocks),
                                        torch.from_numpy(dy), h=h, w=w,
                                        dtype=tdt)
    np.testing.assert_allclose(dxt.numpy(), np.asarray(dxr), rtol=tol_x,
                               atol=tol_x)
    for i, (r, t) in enumerate(zip(dwr, dwt)):
        assert set(r) == set(t)
        for k in r:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(r[k]),
                                       rtol=tol_w, atol=tol_w,
                                       err_msg=f"block{i}.{k}")


def test_stack_matches_reference_pallas_interpret():
    """The port's plain versions == the reference's Pallas kernels 8 and 9
    run in interpret mode (f32; 1e-5 on y and dx, 1e-4 on dW)."""
    x, dy, blocks, h, w = _stack_fixture(seed=1)
    yp = jbt._fwd_pallas(jnp.asarray(x), _j(blocks), h=h, w=w,
                         dtype=jnp.float32, interpret=True)
    got = tbt.train_stack_forward_plain(torch.from_numpy(x), _t(blocks),
                                        h=h, w=w, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(yp), rtol=1e-5,
                               atol=1e-5)
    dxp, dwp = jbt._bwd_pallas(jnp.asarray(x), _j(blocks), jnp.asarray(dy),
                               h=h, w=w, dtype=jnp.float32, interpret=True)
    dxt, dwt = tbt.train_stack_backward_plain(
        torch.from_numpy(x), _t(blocks), torch.from_numpy(dy), h=h, w=w,
        dtype=torch.float32)
    np.testing.assert_allclose(dxt.numpy(), np.asarray(dxp), rtol=1e-5,
                               atol=1e-5)
    for r, t in zip(dwp, dwt):
        for k in r:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(r[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_autograd_function_matches_torch_autograd():
    """BottleneckStackTrain's hand-derived backward == torch.autograd
    through the plain forward (f32, 1e-5); frozen affines get no
    gradient."""
    x, _, blocks, h, w = _stack_fixture(seed=2)

    def run(fn):
        xt = torch.from_numpy(x).requires_grad_()
        bl = [{k: v.requires_grad_(True) for k, v in b.items()}
              for b in _t(blocks)]
        torch.sin(fn(xt, bl)).sum().backward()
        return xt.grad, bl

    def plain(xt, bl):
        for b in bl:
            xt = tbt._block_forward(xt, b, h, w, torch.float32)[0]
        return xt

    gx, bl = run(lambda xt, bl: tbt.bottleneck_stack_train(
        xt, bl, h=h, w=w, dtype=torch.float32))
    rx, rl = run(plain)
    torch.testing.assert_close(gx, rx, rtol=1e-5, atol=1e-5)
    for b, r in zip(bl, rl):
        for k in b:
            if k[0] == "w":
                torch.testing.assert_close(b[k].grad, r[k].grad, rtol=1e-5,
                                           atol=1e-5, msg=k)
            else:
                assert b[k].grad is None, k


def test_stack_refuses_bad_input():
    x, _, blocks, h, w = _stack_fixture()
    with pytest.raises(TypeError):
        tbt.train_stack_forward(torch.from_numpy(x).double(), _t(blocks),
                                h=h, w=w)
    with pytest.raises(ValueError):
        tbt.train_stack_forward(torch.from_numpy(x), _t(blocks), h=w, w=h + 1)
    with pytest.raises(ValueError, match="CUDA"):
        tbt.train_stack_forward_cuda(torch.from_numpy(x), _t(blocks), h=h,
                                     w=w)


# ------------------------------------------------- model, optimizer, step

BASE = dict(num_classes=4, num_segments=2, batch_clips=2,
            compute_dtype="float32", scale_size=36, crop_size=32,
            dropout=0.0, partial_bn=True, lr=0.01, arch="resnet50")


@pytest.fixture(scope="module")
def jax_state():
    """The reference's train state at the settings of its own fused-step
    test (resnet50, crop 32, f32, dropout 0), built once."""
    cfg = jtr.TrainConfig(fused_stage1="off", **BASE)
    return jtr.create_train_state(cfg, jax.random.PRNGKey(0),
                                  sample_hw=(32, 32))


def _weights(state):
    return from_jax_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))


@pytest.mark.parametrize("arch,partial_bn,n_moved", [
    ("resnet50", True, 2), ("resnet18", False, 2 * 20)])
def test_train_mode_forward_matches_flax(jax_state, arch, partial_bn,
                                         n_moved):
    """Train-mode logits and the updated batch_stats == flax
    apply(train=True, mutable=["batch_stats"]) (f32; logits 1e-4,
    batch_stats atol 1e-5). With partial_bn only the stem's stats move.
    Without it every BN normalizes by batch statistics; that case runs on
    resnet18, because 53 batch-statistics BNs over resnet50's 1x1 stage-4
    maps of 4 images amplify f32 summation-order noise to ~1e-3 in both
    frameworks alike."""
    model_j = j_get_arch(arch)[0](
        num_classes=4, dtype=jnp.float32, use_running_average=False,
        partial_bn=partial_bn)
    x = np.random.default_rng(4).normal(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    variables = ({"params": jax_state.params,
                  "batch_stats": jax_state.batch_stats}
                 if arch == "resnet50" else
                 model_j.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]),
                              train=False))
    logits, upd = model_j.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    before = from_jax_variables(jax.tree.map(np.asarray, variables))
    model = ResNet(arch, num_classes=4, partial_bn=partial_bn)
    model.load_state_dict(before)
    model.train()
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    want = from_jax_variables(jax.tree.map(np.asarray, {
        "params": variables["params"], "batch_stats": upd["batch_stats"]}))
    sd = model.state_dict()
    moved = 0
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
            moved += not torch.equal(sd[k], before[k])
    assert moved == n_moved


def test_dropout_keep_rate_and_scale():
    """Dropout in training keeps ~1-p of the pooled features, scaled by
    1/(1-p), from the uniform draw it is given (same draw, same mask;
    kept where the draw is below 1 - p)."""
    model = ResNet("resnet18", num_classes=3, dropout=0.5, width=8)
    model.train()
    x = torch.rand(64, 64, 1, 1) + 0.5
    outs = []
    for _ in range(2):
        noise = torch.rand(64, 64, generator=torch.Generator().manual_seed(9))
        seen = {}
        model.fc.register_forward_hook(
            lambda m, inp, out: seen.setdefault("x", inp[0]))
        model.head(x, noise)
        outs.append(seen["x"])
        model.fc._forward_hooks.clear()
    kept = outs[0] != 0
    assert torch.equal(kept, noise < 0.5)
    assert 0.45 < float(kept.float().mean()) < 0.55
    torch.testing.assert_close(outs[0][kept], 2.0 * x.reshape(64, 64)[kept])
    assert torch.equal(outs[0], outs[1])


def test_optimizer_policy():
    """Decay on conv and fc kernels only; the frozen BN affines are in no
    group and get no gradient; the stem bn1 and fc.bias train undecayed;
    the schedule is optax's staircase exponential decay."""
    cfg = ttr.TrainConfig(**{**BASE, "arch": "resnet18"})
    state = ttr.create_train_state(cfg, "cpu")
    model = state.model
    names = {id(p): n for n, p in model.named_parameters()}
    decay, plain = state.optimizer.param_groups
    assert decay["weight_decay"] == cfg.weight_decay
    assert plain["weight_decay"] == 0.0
    got_plain = sorted(names[id(p)] for p in plain["params"])
    assert got_plain == ["bn1.bias", "bn1.weight", "fc.bias"]
    got_decay = {names[id(p)] for p in decay["params"]}
    assert got_decay == {n for n in names.values() if n.endswith("weight")
                         and "bn" not in n and "downsample.1" not in n}
    for n, p in model.named_parameters():
        frozen = ("bn" in n or "downsample.1" in n) and not n.startswith(
            "bn1")
        assert p.requires_grad != frozen, n
    sched = optax.exponential_decay(cfg.lr, cfg.lr_decay_steps,
                                    cfg.lr_decay_rate, staircase=True)
    for step in (0, 1, 1499, 1500, 1501, 3000, 4499):
        assert ttr.learning_rate(cfg, step) == pytest.approx(
            float(sched(step)), rel=1e-6)


def test_config_refusals():
    with pytest.raises(ValueError, match="use 'auto'"):
        ttr.make_train_step(ttr.TrainConfig(fused_stage1="ON"), "cpu")
    with pytest.raises(ValueError, match="multiscale"):
        ttr.make_train_step(ttr.TrainConfig(augment="flip"), "cpu")
    with pytest.raises(ValueError, match="partial_bn"):
        ttr.make_train_step(ttr.TrainConfig(partial_bn=False,
                                            fused_stage1="on"), "cpu")
    with pytest.raises(ValueError, match="bottleneck"):
        ttr.make_train_step(ttr.TrainConfig(arch="resnet18",
                                            fused_stage1="on"), "cpu")
    with pytest.raises(ValueError, match="fused_stage1"):
        ttr.make_train_step(ttr.TrainConfig(fused_stage2="on",
                                            fused_stage1="off"), "cpu")
    for f in ("stem_s2d", "pool_vjp"):
        with pytest.raises(ValueError, match="fused stem path"):
            ttr.make_train_step(ttr.TrainConfig(fused_stage1="off",
                                                **{f: "on"}), "cpu")
        # Ported: both levers build on the fused route.
        ttr.make_train_step(ttr.TrainConfig(fused_stage1="on", **{f: "on"}),
                            "cpu")
    with pytest.raises(ValueError, match="even crop_size"):
        ttr.make_train_step(ttr.TrainConfig(fused_stage1="on",
                                            stem_s2d="on", crop_size=223),
                            "cpu")
    # 'auto' resolves on only on a CUDA device, and off for basic archs.
    assert ttr.resolve_fused(ttr.TrainConfig(), "cpu") == (False, False)
    assert ttr.resolve_fused(ttr.TrainConfig(), "cuda") == (True, True)
    assert ttr.resolve_fused(ttr.TrainConfig(arch="resnet34"),
                             "cuda") == (False, False)
    assert ttr.resolve_fused(ttr.TrainConfig(fused_stage1="on"),
                             "cpu") == (True, False)


@pytest.fixture(scope="module")
def jax_steps():
    """The reference's jitted train step per (fused_stage1, fused_stage2),
    each built once for the module."""
    cache = {}

    def get(fused):
        if fused not in cache:
            cfg = jtr.TrainConfig(fused_stage1=fused[0],
                                  fused_stage2=fused[1], **BASE)
            cache[fused] = jtr.make_train_step(cfg, donate=False)
        return cache[fused]

    return get


@pytest.fixture(scope="module")
def step_fixture(jax_state):
    """Frames from numpy seed 1. (At seed 0 a ReLU pre-activation of
    layer3.1 lies within f32 summation rounding of zero, so any two conv
    implementations may route its gradient differently; that knife edge
    is the fixture's, not the port's.)"""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, 2, 40, 48, 3), dtype=np.uint8)
    return frames, np.array([1, 3], np.int32)


@pytest.mark.parametrize("jfused,tfused", [
    (("off", "off"), ("off", "off")),
    (("on", "off"), ("on", "off")),
    (("on", "on"), ("on", "on")),
    (("off", "off"), ("on", "on")),
])
def test_three_train_steps_match_reference(jax_state, jax_steps,
                                           step_fixture, jfused, tfused):
    """Three full steps (augment -> forward -> CE -> backward -> SGD): loss
    |d| < 1e-4, every param < 1e-4 and the BN statistics atol 1e-5 against
    the reference, the fused stage 1 and stage-2 tail included."""
    frames, labels = step_fixture
    jstep = jax_steps(jfused)
    cfg = ttr.TrainConfig(fused_stage1=tfused[0], fused_stage2=tfused[1],
                          **BASE)
    state = ttr.create_train_state(cfg, "cpu", weights=_weights(jax_state))
    step = ttr.make_train_step(cfg, "cpu")
    js = jax_state
    for i in range(3):
        js, jm = jstep(js, jnp.asarray(frames), jnp.asarray(labels),
                       jax.random.PRNGKey(7 + i))
        state, m = step(state, torch.from_numpy(frames),
                        torch.from_numpy(labels), prng.key(7 + i))
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-4, i
        assert float(m["accuracy"]) == float(jm["accuracy"])
    assert state.step == 3
    want, sd = _weights(js), state.model.state_dict()
    for k, v in want.items():
        tol = 1e-5 if k.startswith("bn1.running") else 1e-4
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=tol,
                                   rtol=0, err_msg=k)
    assert not torch.equal(sd["bn1.running_mean"],
                           _weights(jax_state)["bn1.running_mean"])


def test_dropout_bf16_step_learns(jax_state):
    """The production combination (bf16, dropout 0.5, fused, the default
    lr) runs and learns on one fixed batch: 5 steps lower the loss."""
    cfg = ttr.TrainConfig(**{**BASE, "compute_dtype": "bfloat16",
                             "dropout": 0.5, "fused_stage1": "on",
                             "fused_stage2": "on", "lr": 0.001})
    state = ttr.create_train_state(cfg, "cpu", weights=_weights(jax_state))
    step = ttr.make_train_step(cfg, "cpu")
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 2, 40, 48, 3), dtype=np.uint8))
    labels = torch.tensor([0, 2])
    key, losses = prng.key(5), []
    for _ in range(5):
        key, sub = prng.split(key, 2).unbind(0)
        state, m = step(state, frames, labels, sub)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_remat_matches_plain_step(jax_state, step_fixture):
    """remat recomputes the unfused blocks in the backward: same loss and
    params as without it (f32, 1e-6), BN statistics updated once."""
    frames, labels = step_fixture
    runs = []
    for remat in (False, True):
        cfg = ttr.TrainConfig(**{**BASE, "partial_bn": False,
                                 "remat": remat})
        state = ttr.create_train_state(cfg, "cpu",
                                       weights=_weights(jax_state))
        step = ttr.make_train_step(cfg, "cpu")
        state, m = step(state, torch.from_numpy(frames),
                        torch.from_numpy(labels), prng.key(3))
        runs.append((float(m["loss"]), state.model.state_dict()))
    assert runs[0][0] == pytest.approx(runs[1][0], abs=1e-6)
    for k, v in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], v, rtol=1e-6, atol=1e-6,
                                   msg=k)


def test_train_config_defaults_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(ttr.TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jtr.TrainConfig)}
    assert ours == ref
