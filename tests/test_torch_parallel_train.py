"""Multi-GPU training of the port on the CPU: a group of two gloo ranks
(``torch_multirank_worker.py train``) against the port's single-process
step on the same global batches and the reference's mesh train step
(``make_train_step(cfg, mesh=make_mesh(2, 1))`` on the virtual CPU
devices).

The ranks run resnet50 at crop 32 in f32 (the train parity tests'
settings), fused stage 1 and stage-2 tail on their plain versions:
3 steps at data 2, 3 steps at data 1 x frame 2, one step with dropout 0.5
at data 2, and the sharded epoch loop (resnet18, 6 clips at batch 4, the
tail wrap-padded) from a state that differs on rank 1 until rank 0's is
broadcast. About 37 s serial.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multirank_worker as W
from torch_flax_variables import to_flax_variables

from eov_tpu import train as jtr
from eov_tpu.parallel.mesh import make_mesh as j_make_mesh

from eov_tpu_torch import prng
from eov_tpu_torch import train as tr
from eov_tpu_torch.data.datasets import SyntheticVideoDataset
from eov_tpu_torch.models.resnet import from_jax_variables


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs several test
    workers on one machine, and each ResNet forward here would otherwise
    spin a thread per core against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.launch("train", str(tmp_path_factory.mktemp("train_group")))


def _single(kw, n_steps):
    """The port's single-process steps on the whole global batch."""
    frames, labels = W.train_frames()
    cfg = tr.TrainConfig(**{**W.TRAIN, **kw})
    state = tr.create_train_state(cfg, "cpu", weights=W.train_weights())
    step = tr.make_train_step(cfg, "cpu")
    losses = []
    for i in range(n_steps):
        state, m = step(state, torch.from_numpy(frames),
                        torch.from_numpy(labels), prng.key(7 + i))
        losses.append((float(m["loss"]), float(m["accuracy"])))
    return losses, state.model.state_dict()


def _close(got: dict, want: dict, tol: float = 1e-4):
    for k, v in want.items():
        t = 1e-5 if k.startswith("bn1.running") else tol
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=t,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name,kw,n_steps", [
    ("d2", {}, 3), ("f2", {}, 3), ("dropout", {"dropout": 0.5}, 1)])
def test_sharded_steps_match_single_process(ranks, name, kw, n_steps):
    """Losses |d| < 1e-4, accuracy equal, every parameter within 1e-4 and
    the stem BN's running statistics within 1e-5 of the single-process
    steps, on both ranks (which agree with each other bit for bit). At
    dropout 0.5 the global-shape mask gives the single-process mask: the
    loss differs from the dropout-0 loss and matches. The trained BN's
    cross-rank statistics hook lasts one step: none is left on the model."""
    want_losses, want = _single(kw, n_steps)
    r0, r1 = (r[name] for r in ranks)
    assert r0["losses"] == r1["losses"]
    assert r0["bn_hooks_left"] == r1["bn_hooks_left"] == 0
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    assert r0["step"] == n_steps
    for (lg, ag), (lw, aw) in zip(r0["losses"], want_losses):
        assert abs(lg - lw) < 1e-4
        assert ag == aw
    _close(r0["state"], want)
    if name == "dropout":
        assert abs(r0["losses"][0][0] - ranks[0]["d2"]["losses"][0][0]) > 1e-2


def test_sharded_steps_match_reference_mesh_step(ranks):
    """The data-2 ranks against the reference's mesh step (pjit over
    make_mesh(2, 1), the unfused flax route) from the same weights: losses
    and parameters within 1e-4, the stem BN statistics within 1e-5."""
    frames, labels = W.train_frames()
    jcfg = jtr.TrainConfig(**{**W.TRAIN, "fused_stage1": "off",
                              "fused_stage2": "off"})
    v = to_flax_variables(W.train_weights())
    params = jax.tree.map(jnp.asarray, v["params"])
    js = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 v["batch_stats"]),
                        opt_state=jtr._make_tx(jcfg).init(params))
    jstep = jtr.make_train_step(jcfg, mesh=j_make_mesh(2, 1), donate=False)
    got = ranks[0]["d2"]
    for i in range(3):
        js, jm = jstep(js, jnp.asarray(frames),
                       jnp.asarray(labels.astype(np.int32)),
                       jax.random.PRNGKey(7 + i))
        assert abs(got["losses"][i][0] - float(jm["loss"])) < 1e-4, i
        assert got["losses"][i][1] == float(jm["accuracy"])
    want = from_jax_variables(jax.tree.map(np.asarray, {
        "params": js.params, "batch_stats": js.batch_stats}))
    _close(got["state"], want)


def test_sharded_epoch_matches_single_process(ranks):
    """train_epoch(mesh=) at data 2 (each rank decodes its rows of every
    global batch; the state starts from rank 0's) equals the
    single-process epoch: the same steps, clips and loss, parameters
    within 1e-4."""
    cfg = tr.TrainConfig(**{**W.TRAIN, "arch": "resnet18", "batch_clips": 4,
                            "fused_stage1": "off", "fused_stage2": "off"})
    ds = SyntheticVideoDataset(n_classes=3, clips_per_class=2, height=40,
                               width=48, seed=2)
    state = tr.create_train_state(cfg, "cpu")
    state, m = tr.train_epoch(state, tr.make_train_step(cfg, "cpu"), cfg,
                              ds, epoch=1)
    for r in ranks:
        got = r["epoch"]
        assert got["metrics"]["steps"] == m["steps"] == 2
        assert got["metrics"]["clips"] == m["clips"] == 6
        assert abs(got["metrics"]["loss"] - m["loss"]) < 1e-4
        assert got["metrics"]["accuracy"] == m["accuracy"]
        _close(got["state"], state.model.state_dict())
