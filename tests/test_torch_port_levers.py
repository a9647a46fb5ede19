"""The train stem's two levers against the JAX reference on the CPU:
``pool_vjp`` (the stem pool with the reference's first-max backward),
``stem_s2d`` (the stem conv by space-to-depth from its own 7x7
parameter), and three train steps with each of them on.

Inputs come from numpy seeds; weights cross over with
``from_jax_variables``. The reference's fused train stack runs its
reference implementation off the TPU; the port's ops take their plain
versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu import train as jtr
from eov_tpu.models.fused_train import _S2DConv1 as JS2DConv1
from eov_tpu.ops.pool import maxpool_3x3_s2_vjp as j_pool_vjp

from torch_flax_variables import to_flax_variables

from eov_tpu_torch import prng
from eov_tpu_torch import train as ttr
from eov_tpu_torch.models.fused_train import ResNetStem, _S2DConv1
from eov_tpu_torch.models.resnet import (ResNet, from_jax_variables,
                                         random_state_dict)
from eov_tpu_torch.ops.pool import _MaxPoolVJP, maxpool_3x3_s2_vjp

# ------------------------------------------------------------- pool_vjp


def _pool_inputs(kind, shape, seed):
    """Inputs built to tie: a ReLU over small integers (whole zero windows
    and repeated maxima), or a few repeated values of any sign."""
    rng = np.random.default_rng(seed)
    if kind == "relu_zeroed":
        return np.maximum(rng.integers(-3, 3, shape), 0).astype(np.float32)
    return rng.choice(np.float32([-1.5, 0.25, 0.75, 2.0]), size=shape)


def _cotangent(shape, seed):
    """Cotangents whose bf16 sums round differently by order: values with
    bits past bf16's mantissa, spread over a few octaves."""
    n, h, w, c = shape
    rng = np.random.default_rng(seed + 1)
    g = rng.normal(size=(n, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c))
    g *= 2.0 ** rng.integers(-3, 4, g.shape)
    return g.astype(np.float32)


@jax.jit
def _j_pool_and_vjp(x, g):
    y, vjp = jax.vjp(j_pool_vjp, x)
    return y, vjp(g)[0]


def _bits(x):
    """Bit patterns of an f32 or bf16 array (so -0.0 != +0.0)."""
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("kind", ["relu_zeroed", "repeated"])
@pytest.mark.parametrize("shape", [(2, 8, 10, 3), (1, 7, 9, 4),
                                   (2, 12, 12, 5)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_pool_vjp_bit_equal_to_reference(kind, shape, dt):
    """Forward and gradient bit-equal to jax.vjp of the reference's
    custom-VJP pool (jitted, as the train step runs it), on tied inputs,
    even and odd H/W, f32 and bf16."""
    x = _pool_inputs(kind, shape, seed=sum(shape))
    g = _cotangent(shape, seed=sum(shape))
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    y_j, gx_j = _j_pool_and_vjp(jnp.asarray(x, jdt), jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y_t = maxpool_3x3_s2_vjp(xt)
    y_t.backward(torch.from_numpy(g).to(tdt))
    assert xt.grad.dtype == tdt
    to_np = (lambda t: t.detach().view(torch.int16).numpy().view(np.uint16)
             if tdt == torch.bfloat16 else t.detach().numpy())
    np.testing.assert_array_equal(_bits(to_np(y_t)), _bits(y_j))
    np.testing.assert_array_equal(_bits(to_np(xt.grad)), _bits(gx_j))


def test_pool_vjp_ties_differ_from_max_pool2d_routing():
    """On a zero window the first tap takes the whole cotangent (the
    reference's rule); the gradient sums to the cotangent's sum."""
    x = torch.zeros(1, 4, 4, 1, requires_grad=True)
    maxpool_3x3_s2_vjp(x).backward(torch.ones(1, 2, 2, 1))
    want = torch.zeros(1, 4, 4, 1)
    # Window (i, j) starts at padded (2i, 2j); its first in-bounds tap is
    # input (max(2i - 1, 0), max(2j - 1, 0)).
    for i in range(2):
        for j in range(2):
            want[0, max(2 * i - 1, 0), max(2 * j - 1, 0), 0] += 1
    assert torch.equal(x.grad, want)


# ------------------------------------------------------------ _S2DConv1

@pytest.mark.parametrize("h,w", [(32, 32), (22, 40)])
def test_s2d_conv1_matches_reference(h, w):
    """Output and the 7x7 parameter's gradient == the reference module's
    apply and jax.grad, f32, rtol 1e-5 (the gradient's atol 1e-5 of its
    largest entry)."""
    rng = np.random.default_rng(h + w)
    width = 8
    kernel = rng.normal(0, 0.2, (7, 7, 3, width)).astype(np.float32)
    x = rng.normal(0, 1, (2, h, w, 3)).astype(np.float32)
    # A fixed cotangent (a linear loss), so the gradient's error is the
    # sums' rounding, not the output's rounding through a nonlinearity.
    ct = rng.normal(0, 1, (2, h // 2, w // 2, width)).astype(np.float32)
    mod = JS2DConv1(width=width, dtype=jnp.float32)

    def loss(k):
        return jnp.sum(mod.apply({"params": {"kernel": k}},
                                 jnp.asarray(x)) * ct)

    y_j = mod.apply({"params": {"kernel": jnp.asarray(kernel)}},
                    jnp.asarray(x))
    g_j = jax.grad(loss)(jnp.asarray(kernel))

    model = ResNet("resnet18", width=width)
    with torch.no_grad():
        model.conv1.weight.copy_(torch.from_numpy(
            kernel.transpose(3, 2, 0, 1).copy()))
    y_t = _S2DConv1(model)(torch.from_numpy(x))
    (y_t * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_j), rtol=1e-5, atol=1e-5)
    # Each gradient entry sums 2 * (h/2) * (w/2) products; its f32
    # rounding scales with the gradient's size, so atol is relative to it.
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(
        model.conv1.weight.grad.permute(2, 3, 1, 0).numpy(), g_j,
        rtol=1e-5, atol=1e-5 * np.abs(g_j).max())
    # The 7x7/s2 stem conv computes the same values.
    with torch.no_grad():
        ref = model.conv1(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(y_t.detach(), ref, rtol=1e-5, atol=1e-5)


def test_s2d_stem_refuses_odd_frames():
    model = ResNet("resnet18", width=8)
    with pytest.raises(ValueError, match="even"):
        ResNetStem(model, s2d=True)(torch.zeros(1, 31, 32, 3))


# ------------------------------------------------------- three train steps

BASE = dict(num_classes=4, num_segments=2, batch_clips=2,
            compute_dtype="float32", scale_size=36, crop_size=32,
            dropout=0.0, partial_bn=True, lr=0.01, arch="resnet50",
            fused_stage1="on", fused_stage2="on")


@pytest.fixture(scope="module")
def jax_state():
    """The reference's train state over seeded random weights (built
    without flax's init, which is slow on the CPU)."""
    cfg = jtr.TrainConfig(**BASE)
    v = to_flax_variables(random_state_dict("resnet50", seed=0,
                                            num_classes=4))
    return jtr.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=jtr._make_tx(cfg).init(v["params"]))


def _weights(state):
    return from_jax_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))


@pytest.mark.parametrize("levers", [{"stem_s2d": "on"}, {"pool_vjp": "on"}])
def test_three_lever_steps_match_reference(jax_state, levers, monkeypatch):
    """Three full fused steps with the lever(s) on: loss |d| < 1e-4, every
    param < 1e-4 and the BN statistics atol 1e-5 against the reference's
    make_train_step with the same TrainConfig (the bars of
    test_torch_port_train.py's three-step fixture, on its frames). In f32
    a lever moves the result by rounding alone, so spies on ``_S2DConv1``'s
    forward and the first-max pool's backward show that each step took the
    lever's path, and only that lever's."""
    calls = {"stem_s2d": 0, "pool_vjp": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(_S2DConv1, "forward",
                        spy("stem_s2d", _S2DConv1.forward))
    monkeypatch.setattr(_MaxPoolVJP, "backward", staticmethod(
        spy("pool_vjp", _MaxPoolVJP.backward)))
    frames = np.random.default_rng(1).integers(
        0, 256, (2, 2, 40, 48, 3), dtype=np.uint8)
    labels = np.array([1, 3], np.int32)
    jstep = jtr.make_train_step(jtr.TrainConfig(**BASE, **levers),
                                donate=False)
    cfg = ttr.TrainConfig(**BASE, **levers)
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
    want, sd = _weights(js), state.model.state_dict()
    assert set(sd) == set(want)  # the checkpoint layout is unchanged
    for k, v in want.items():
        tol = 1e-5 if k.startswith("bn1.running") else 1e-4
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=tol,
                                   rtol=0, err_msg=k)
    assert not torch.equal(sd["conv1.weight"],
                           _weights(jax_state)["conv1.weight"])
    assert calls == {f: 3 if f in levers else 0 for f in calls}, calls


def test_pool_vjp_step_equals_off_step(jax_state):
    """pool_vjp changes only the backward's tie routing: the first step's
    loss equals the lever-off step's."""
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 2, 40, 48, 3), dtype=np.uint8))
    labels = torch.tensor([0, 2])
    losses = []
    for lever in ("off", "on"):
        cfg = ttr.TrainConfig(**BASE, pool_vjp=lever)
        state = ttr.create_train_state(cfg, "cpu",
                                       weights=_weights(jax_state))
        _, m = ttr.make_train_step(cfg, "cpu")(state, frames, labels,
                                               prng.key(3))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]


def test_lever_refusals():
    """The reference's refusals: 'on' without fused_stage1, unknown
    spellings, an odd crop under stem_s2d; 'auto' stays off."""
    for f in ("stem_s2d", "pool_vjp"):
        with pytest.raises(ValueError, match="fused stem path"):
            ttr.make_train_step(ttr.TrainConfig(fused_stage1="off",
                                                **{f: "on"}), "cpu")
        with pytest.raises(ValueError, match="use 'auto'"):
            ttr.make_train_step(ttr.TrainConfig(fused_stage1="on",
                                                **{f: "1"}), "cpu")
    with pytest.raises(ValueError, match="even crop_size"):
        ttr.make_train_step(ttr.TrainConfig(fused_stage1="on",
                                            stem_s2d="on", crop_size=223),
                            "cpu")
    model = ResNet("resnet18", width=8)
    stem = ResNetStem(model)
    assert not (stem.s2d or stem.pool_vjp)
    assert ttr.TrainConfig().stem_s2d == ttr.TrainConfig().pool_vjp == "auto"
