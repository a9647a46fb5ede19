"""The port's embodied fusion, classify, episode and store-info against the
JAX reference on the CPU.

Feature tables are made with numpy from a seed and handed to both
packages; the CLI runs in-process on tiny stores that the port's own
``extract`` writes (resnet18, 32x32 crops, int8).
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu import embodied as jemb
from eov_tpu.data.store import FeatureStore as JStore
from eov_tpu.eval import EvalConfig as JEvalConfig
from eov_tpu.eval import FeatureTable as JTable
from eov_tpu.eval import evaluate as j_evaluate
from eov_tpu.ops import similarity as jsim

from eov_tpu_torch import cli, embodied
from eov_tpu_torch.data.datasets import SyntheticVideoDataset
from eov_tpu_torch.data.store import FeatureStore
from eov_tpu_torch.eval import EvalConfig, FeatureTable, evaluate
from eov_tpu_torch.extract import make_feature_fn
from eov_tpu_torch.models.resnet import random_state_dict

REAL = ["High Jump", "long_jump", "PoleVault", "shot put", "Triple-Jump"]
VIRTUAL = ["HighJump", "pole vault", "Long Jump", "triplejump", "Discus"]


def _bank(c, m, d, seed, full=False):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((c, m, d)).astype(np.float32)
    feats += 0.5 * rng.standard_normal((c, 1, d)).astype(np.float32)
    counts = np.full(c, m) if full else rng.integers(0, m + 1, c)
    for ci, n in enumerate(counts):
        feats[ci, n:] = 0.0
    return feats, counts


def _pair(feats, counts):
    return (FeatureTable(torch.from_numpy(feats), torch.from_numpy(counts)),
            JTable(jnp.asarray(feats), jnp.asarray(counts, jnp.int32)))


def test_align_and_union_match_reference():
    """Mixed name styles align by normalized name; a real class with no
    virtual counterpart ('shot put') gets count 0, the unmatched virtual
    class is dropped."""
    vf, vc = _bank(len(VIRTUAL), 3, 16, 1)
    vc[:] = [3, 2, 1, 3, 2]
    ours_v, theirs_v = _pair(vf, vc)
    got = embodied.align_virtual_bank(REAL, VIRTUAL, ours_v)
    want = jemb.align_virtual_bank(REAL, VIRTUAL, theirs_v)
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(want.features))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.counts.tolist() == [3, 1, 2, 0, 3]
    rf, rc = _bank(len(REAL), 2, 16, 2, full=True)
    ours_r, theirs_r = _pair(rf, rc)
    feats, mask = embodied.union_support(ours_r, REAL, VIRTUAL, ours_v)
    jf, jm = jemb.union_support(theirs_r, REAL, VIRTUAL, theirs_v)
    np.testing.assert_array_equal(feats.numpy(), jf)
    np.testing.assert_array_equal(mask.numpy(), jm)
    assert tuple(feats.shape) == (5, 5, 16)
    plain, _ = embodied.union_support(ours_r, REAL)
    assert tuple(plain.shape) == (5, 2, 16)


def test_align_refusals():
    """Both of the reference's 'silently equals plain eval' refusals and the
    empty-name refusal, in both packages."""
    vf, vc = _bank(2, 3, 8, 3, full=True)
    ours, theirs = _pair(vf, vc)
    for mod, table in ((embodied, ours), (jemb, theirs)):
        with pytest.raises(ValueError, match="ANY real class"):
            mod.align_virtual_bank(["a", "b"], ["c", "d"], table)
        with pytest.raises(ValueError, match="no class names"):
            mod.align_virtual_bank([], ["a", "b"], table)
    zero = np.zeros(2, np.int64)
    ours0, theirs0 = _pair(vf, zero)
    for mod, table in ((embodied, ours0), (jemb, theirs0)):
        with pytest.raises(ValueError, match="0 clips"):
            mod.align_virtual_bank(["a", "b"], ["A", "B"], table)
    rf, rc = _bank(2, 2, 4, 4, full=True)
    with pytest.raises(ValueError, match="different backbones"):
        embodied.union_support(_pair(rf, rc)[0], ["a", "b"], ["a", "b"],
                               ours)


@pytest.mark.parametrize("fusion,metric", [("max", "cosine"),
                                           ("mean", "cosine"),
                                           ("max", "euclidean")])
def test_embodied_evaluate_equals_reference(fusion, metric):
    """Embodied eval, port vs reference on the same tables: equal
    per-episode vectors; and the virtual bank changes some episodes."""
    rf, rc = _bank(8, 4, 32, 5)
    rc[rc < 2] = 2
    vf, vc = _bank(8, 3, 32, 6)
    vf += 0.3 * rf[:, :1]  # virtual clips near their class
    ours_r, theirs_r = _pair(rf, rc)
    ours_v, theirs_v = _pair(vf, vc)
    cfg = dict(n_way=5, k_shot=1, n_query=1, n_episodes=130,
               episodes_per_step=32, seed=3, fusion=fusion, metric=metric)
    got = evaluate(ours_r, EvalConfig(embodied=True, **cfg), virtual=ours_v)
    want = j_evaluate(theirs_r, JEvalConfig(embodied=True, **cfg),
                      virtual=theirs_v)
    np.testing.assert_array_equal(got.per_episode, want.per_episode)
    assert str(got) == str(want)
    plain = evaluate(ours_r, EvalConfig(**cfg))
    assert (plain.per_episode != got.per_episode).any()


def test_evaluate_embodied_refusals():
    rf, rc = _bank(6, 3, 16, 7, full=True)
    table = _pair(rf, rc)[0]
    with pytest.raises(ValueError, match="requires a virtual"):
        evaluate(table, EvalConfig(embodied=True))
    vf, vc = _bank(6, 2, 8, 8, full=True)
    with pytest.raises(ValueError, match="different backbones"):
        evaluate(table, EvalConfig(embodied=True), virtual=_pair(vf, vc)[0])


SMALL = ["--device", "cpu", "--preset", "synthetic_smoke", "--arch",
         "resnet18", "--num-segments", "2", "--synthetic-classes", "4",
         "--synthetic-height", "40", "--synthetic-width", "48",
         "--scale-size", "40", "--crop-size", "32"]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """An int8 real store (4 classes x 2 clips) and an int8 virtual store
    (4 classes x 1 clip), both written by the port's extract."""
    root = tmp_path_factory.mktemp("stores")
    real, virt = str(root / "real"), str(root / "virt")
    assert cli.main(["extract", *SMALL, "--store", real, "--quant", "int8",
                     "--synthetic-clips", "2"]) == 0
    assert cli.main(["extract", *SMALL, "--store", virt, "--quant", "int8",
                     "--synthetic-clips", "1", "--synthetic-virtual"]) == 0
    return real, virt


def test_classify_matches_reference_scores(stores, tmp_path, capsys):
    """classify --quant int8 --embodied: queries (the same classes, other
    frame counts) featurized with the store's recorded scales; predictions
    equal the argmax of the reference's fused_class_scores over the
    reference's union support of the same stores."""
    real, virt = stores
    out = str(tmp_path / "preds.jsonl")
    query = ["--synthetic-clips", "3", "--params"]
    weights = str(tmp_path / "w.npz")
    np.savez(weights, **{k: v.numpy() for k, v in
                         random_state_dict("resnet18", seed=0).items()})
    capsys.readouterr()
    assert cli.main(["classify", *SMALL, "--seed", "4", *query, weights,
                     "--store", real, "--quant", "int8", "--embodied",
                     "--virtual-store", virt, "--out", out]) == 0
    assert "accuracy" in capsys.readouterr().err
    with open(out) as f:
        got = {d["video_id"]: d["pred_class"] for d in map(json.loads, f)}

    from eov_tpu_torch.cli import _extract_config
    from eov_tpu_torch.data.segments import center_indices_np

    args = cli.argparse.Namespace(
        preset="synthetic_smoke", arch="resnet18", num_segments=2,
        batch=None, scale_size=40, crop_size=32, quant="int8")
    cfg = _extract_config(args)
    ds = SyntheticVideoDataset(n_classes=4, clips_per_class=3, height=40,
                               width=48, seed=4)
    fn = make_feature_fn(random_state_dict("resnet18", seed=0), cfg, "cpu",
                         act_max=FeatureStore(real).quant_calib())
    recs = sorted(ds.records, key=lambda r: r.video_id)
    q = fn(torch.from_numpy(np.stack([
        ds.get_frames(r, center_indices_np(r.num_frames, 2))
        for r in recs]))).numpy()
    jr, jv = JStore(real, process_index=0), JStore(virt, process_index=0)
    feats, mask = jemb.union_support(
        jr.to_table(n_classes=len(jr.class_names)), jr.class_names,
        jv.class_names, jv.to_table())
    scores = np.array(jsim.fused_class_scores(q, feats, mask))
    scores[:, mask.sum(axis=1) == 0] = -np.inf
    want = {r.video_id: jr.class_names[int(i)]
            for r, i in zip(recs, scores.argmax(axis=-1))}
    assert got == want


def test_classify_provenance(stores, tmp_path, capsys):
    """An int8 store against bf16/f32 queries is refused; an int8 store that
    records no scales is warned about (and classified with local
    synthetic scales)."""
    real, _ = stores
    with pytest.raises(SystemExit, match="quant=int8"):
        cli.main(["classify", *SMALL, "--synthetic-clips", "1", "--store",
                  real])
    bare = str(tmp_path / "bare")
    shutil.copytree(real, bare)
    with open(os.path.join(bare, "manifest.json")) as f:
        doc = json.load(f)
    del doc["quant_calib"]
    with open(os.path.join(bare, "manifest.json"), "w") as f:
        json.dump(doc, f)
    capsys.readouterr()
    assert cli.main(["classify", *SMALL, "--synthetic-clips", "1",
                     "--store", bare, "--quant", "int8"]) == 0
    cap = capsys.readouterr()
    assert "records no calibration scales" in cap.err
    lines = [json.loads(x) for x in cap.out.strip().splitlines()]
    assert len(lines) == 4 and set(lines[0]) == {"video_id", "pred_class",
                                                 "score"}
    with pytest.raises(SystemExit, match="precisions"):
        plain = str(tmp_path / "plain_virt")
        s = FeatureStore(plain, class_names=["a"], quant=None)
        s.put("v", np.zeros(512, np.float32), 0)
        s.flush()
        cli.main(["eval", "--device", "cpu", "--preset", "synthetic_smoke",
                  "--store", real, "--embodied", "--virtual-store", plain])


def test_episode_and_store_info_keys(stores, capsys):
    """episode prints the reference's keys; store-info prints the
    reference's summary of the same store, key for key."""
    real, _ = stores
    capsys.readouterr()
    assert cli.main(["episode", *SMALL, "--synthetic-clips", "2",
                     "--n-way", "3"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(doc) == {"n_way", "accuracy", "preds", "truth"}
    assert doc["n_way"] == 3 and doc["truth"] == [0, 1, 2]
    assert cli.main(["store-info", "--store", real]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info == JStore(real, process_index=0).summary()
    assert info["quant"] == "int8" and info["quant_calib"] is True
    with pytest.raises(SystemExit, match="no feature store"):
        cli.main(["store-info", "--store", real + "_missing"])


def test_new_commands_need_a_gpu_by_default(stores):
    """Without --device, classify, episode and embodied eval run on cuda and
    raise on a machine without it instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    real, virt = stores
    cpu_free = [a for a in SMALL if a not in ("--device", "cpu")]
    for argv in (["classify", *cpu_free, "--store", real, "--quant", "int8"],
                 ["episode", *cpu_free],
                 ["eval", "--store", real, "--embodied", "--virtual-store",
                  virt]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
