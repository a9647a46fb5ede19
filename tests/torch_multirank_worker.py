"""One rank of a CPU (gloo) group that drives eov_tpu_torch's multi-GPU
paths; the tests launch a group of these and check what the ranks write.

    python tests/torch_multirank_worker.py SCENARIO RANK WORLD INIT OUT

SCENARIO is ``pipeline`` (helpers, sharded extraction at data 2 and at
frame 2, int8 with rank 0's broadcast scales, unbalanced ranks with
resume, sharded eval) or ``train`` (sharded train steps at data 2 and at
frame 2, dropout, the sharded epoch loop). INIT is the group's
``init_method`` (``file://...``); each rank saves its results to
``OUT/rank{RANK}.pt``. Imports no JAX.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from eov_tpu_torch import prng  # noqa: E402
from eov_tpu_torch.data.datasets import SyntheticVideoDataset  # noqa: E402
from eov_tpu_torch.data.store import FeatureStore  # noqa: E402
from eov_tpu_torch.eval import EvalConfig, FeatureTable  # noqa: E402
from eov_tpu_torch.extract import (ExtractConfig, extract_features,  # noqa
                                   quant_calibration)
from eov_tpu_torch.models.resnet import random_state_dict  # noqa: E402
from eov_tpu_torch.parallel import distributed as pdist  # noqa: E402
from eov_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from eov_tpu_torch.parallel.sharded import (evaluate_sharded,  # noqa: E402
                                            make_sharded_feature_fn)

# Shared with the tests: the fixtures every rank and the test process build.
EXTRACT = dict(arch="resnet18", num_segments=2, batch_clips=4, scale_size=32,
               crop_size=32, compute_dtype="float32", deterministic=True,
               flush_every=4)
TRAIN = dict(num_classes=4, num_segments=2, batch_clips=2,
             compute_dtype="float32", scale_size=36, crop_size=32,
             dropout=0.0, partial_bn=True, lr=0.01, arch="resnet50",
             fused_stage1="on", fused_stage2="on")
EVAL_PLAIN = dict(n_way=3, k_shot=1, n_query=2, n_episodes=50,
                  episodes_per_step=7, seed=3)
EVAL_EMBODIED = dict(EVAL_PLAIN, embodied=True, fusion="max")


def dataset():
    return SyntheticVideoDataset(n_classes=4, clips_per_class=3, height=32,
                                 width=40, seed=0)


def virtual_bank(d: int) -> FeatureTable:
    rng = np.random.default_rng(11)
    return FeatureTable(
        torch.from_numpy(rng.standard_normal((4, 3, d)).astype(np.float32)),
        torch.tensor([3, 1, 0, 2]))


def train_frames():
    """The train parity tests' fixture: numpy seed 1, 2 clips x 2 segments
    at 40x48, labels [1, 3]."""
    rng = np.random.default_rng(1)
    return (rng.integers(0, 256, (2, 2, 40, 48, 3), dtype=np.uint8),
            np.array([1, 3], np.int64))


def train_weights():
    return random_state_dict("resnet50", seed=1, num_classes=4)


def _store(out, name, ds, mesh, quant=None):
    return FeatureStore(os.path.join(out, name),
                        class_names=list(ds.class_names),
                        process_index=mesh.data_index, quant=quant)


def pipeline(rank: int, out: str) -> dict:
    res = {"global_max": pdist.global_max(3 + 5 * rank)}
    m21, m12 = make_mesh(2, 1), make_mesh(1, 2)
    res["mesh"] = [(m.data_index, m.frame_index) for m in (m21, m12)]
    res["shard_data"] = pdist.process_record_shard(list(range(7)), m21)
    res["shard_frame"] = pdist.process_record_shard(list(range(7)), m12)
    for name, kw in (("bad_frame", {"n_frame": 3}),
                     ("bad_size", {"n_data": 2, "n_frame": 2})):
        try:
            make_mesh(**kw)
        except ValueError as e:
            res[name] = str(e)

    ds = dataset()
    weights = random_state_dict("resnet18", seed=0)
    cfg = ExtractConfig(**EXTRACT)
    for name, mesh in (("d2", m21), ("f2", m12)):
        res[f"stats_{name}"] = extract_features(
            ds, weights, _store(out, name, ds, mesh), cfg, device="cpu",
            mesh=mesh)

    # int8: every rank passes its own scales; rank 0's are used.
    cfg8 = dataclasses.replace(cfg, quant="int8")
    act = quant_calibration(weights, cfg8, device="cpu")
    if rank:
        act = {k: 2.0 * v for k, v in act.items()}
    fn = make_sharded_feature_fn(weights, m21, cfg8, act_max=act,
                                 device="cpu")
    res["act_max"] = fn.act_max
    res["stats_i8"] = extract_features(
        ds, weights, _store(out, "i8", ds, m21, "int8"), cfg8,
        feature_fn=fn, device="cpu", mesh=m21)

    # Unbalanced ranks with resume: rank 0 owns 5 records, rank 1 two;
    # each first extracts a prefix of its own (2 and 1), then all of its
    # own, one clip a rank a step (rank 1 pads two steps).
    own = ds.records[:5] if rank == 0 else ds.records[5:7]
    ub = dataclasses.replace(cfg, batch_clips=2)
    for name, recs in (("prefix", own[:2 - rank]), ("all", own)):
        res[f"stats_ub_{name}"] = extract_features(
            ds, weights, _store(out, "ub", ds, m21), ub, device="cpu",
            records=recs, mesh=m21)

    table = FeatureStore(os.path.join(out, "d2")).to_table("cpu")
    virt = virtual_bank(table.features.shape[-1])
    for name, kw in (("plain", EVAL_PLAIN), ("embodied", EVAL_EMBODIED)):
        res[f"eval_{name}"] = evaluate_sharded(
            table, EvalConfig(**kw), m21,
            virtual=virt if kw.get("embodied") else None).per_episode
    return res


def train(rank: int, out: str) -> dict:
    from eov_tpu_torch import train as tr

    frames, labels = train_frames()
    res = {}
    for name, mesh, kw, n_steps in (
            ("d2", make_mesh(2, 1), {}, 3),
            ("f2", make_mesh(1, 2), {}, 3),
            ("dropout", make_mesh(2, 1), {"dropout": 0.5}, 1)):
        cfg = tr.TrainConfig(**{**TRAIN, **kw})
        state = tr.create_train_state(cfg, "cpu", weights=train_weights())
        step = tr.make_train_step(cfg, "cpu", mesh=mesh)
        rows = pdist.host_local_rows(mesh, frames.shape[0])
        segs = pdist.host_local_frames(mesh, frames.shape[1])
        losses = []
        for i in range(n_steps):
            state, m = step(state, torch.from_numpy(frames[rows, segs]),
                            torch.from_numpy(labels[rows]), prng.key(7 + i))
            losses.append((float(m["loss"]), float(m["accuracy"])))
        res[name] = {"losses": losses, "step": state.step,
                     "state": {k: v.clone() for k, v in
                               state.model.state_dict().items()},
                     "bn_hooks_left": sum(
                         getattr(m, "stats_reduce", None) is not None
                         for m in state.model.modules())}

    # The sharded epoch loop (resnet18, 6 clips at batch 4: the tail is
    # wrap-padded) against the single-process epoch in the test.
    cfg = tr.TrainConfig(**{**TRAIN, "arch": "resnet18", "batch_clips": 4,
                            "fused_stage1": "off", "fused_stage2": "off"})
    ds = SyntheticVideoDataset(n_classes=3, clips_per_class=2, height=40,
                               width=48, seed=2)
    state = tr.create_train_state(cfg, "cpu")
    if rank:  # rank 0's state is every rank's
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    mesh = make_mesh(2, 1)
    state, m = tr.train_epoch(state, tr.make_train_step(cfg, "cpu", mesh),
                              cfg, ds, epoch=1, mesh=mesh)
    res["epoch"] = {"metrics": m, "state": {
        k: v.clone() for k, v in state.model.state_dict().items()}}
    return res


def launch(scenario: str, out: str, world: int = 2,
           timeout: float = 240) -> list[dict]:
    """Run a group of ``world`` ranks of ``scenario`` (this file, one
    process a rank) and return each rank's results; a rank that fails or
    outlives ``timeout`` fails the group (every rank is killed)."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    init = "file://" + os.path.join(out, "init")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), init, out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main() -> int:
    scenario, rank, world, init, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    pdist.initialize("gloo", init_method=init, world_size=world, rank=rank,
                     device="cpu")
    res = {"pipeline": pipeline, "train": train}[scenario](rank, out)
    pdist.barrier()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
