"""The port's tools and small commands against the reference, on the CPU:
``tools/compare_eval``, ``tools/profile_summary`` with ``--trace``, ``eval
--matcher``, ``extract_features(records=)`` with ``pad_batches``, and the
CLI's ``presets``, ``fixtures``, ``--debug-nans`` and ``--platform``.
About 25 s.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eov_tpu import cli as jcli
from eov_tpu.eval import EvalConfig as JEvalConfig
from eov_tpu.eval import FeatureTable as JTable
from eov_tpu.eval import evaluate as j_evaluate
from eov_tpu.tools import compare_eval as jcompare

from eov_tpu_torch import cli
from eov_tpu_torch.data.datasets import SyntheticVideoDataset
from eov_tpu_torch.data.store import MemoryFeatureStore
from eov_tpu_torch.eval import EvalConfig, FeatureTable, evaluate
from eov_tpu_torch.extract import (ExtractConfig, extract_features,
                                   make_feature_fn)
from eov_tpu_torch.models.resnet import random_state_dict
from eov_tpu_torch.tools import compare_eval, profile_summary
from eov_tpu_torch.utils.debug import check_finite, debug_nans

SMALL = ["--device", "cpu", "--preset", "synthetic_smoke", "--arch",
         "resnet18", "--synthetic-classes", "4", "--synthetic-clips", "3",
         "--synthetic-height", "40", "--synthetic-width", "48",
         "--scale-size", "40", "--crop-size", "32"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A small store written by the port's extract (resnet18, 4 x 3)."""
    path = str(tmp_path_factory.mktemp("tools") / "store")
    assert cli.main(["extract", *SMALL, "--store", path]) == 0
    return path


def _eval_doc(tmp_path, name, *extra, package=cli):
    out = str(tmp_path / f"{name}.json")
    argv = ["eval", "--preset", "synthetic_smoke", "--per-episode-out", out,
            *extra]
    assert package.main(argv) == 0
    return out


def _compare_out(module, a, b, capsys):
    code = module.main([a, b])
    got = capsys.readouterr()
    return code, got.out, got.err


def test_compare_eval_equals_reference(store, tmp_path, capsys):
    """The port's compare_eval prints what the reference's prints, on a
    pair the port wrote (two matchers, the same episodes)."""
    a = _eval_doc(tmp_path, "xla", "--device", "cpu", "--store", store,
                  "--matcher", "xla")
    b = _eval_doc(tmp_path, "auto", "--device", "cpu", "--store", store,
                  "--metric", "euclidean")
    capsys.readouterr()
    ours = _compare_out(compare_eval, a, b, capsys)
    ref = _compare_out(jcompare, a, b, capsys)
    assert ours == ref and ours[0] == 0
    out = json.loads(ours[1])
    assert out["variant_a"]["matcher"] == "xla"
    assert out["variant_b"]["metric"] == "euclidean"
    with open(a) as f:
        assert json.load(f)["config"]["matcher"] == "xla"


def test_compare_eval_pairs_across_packages(store, tmp_path, capsys):
    """A port file and a reference file of the same store, seed and
    protocol score the same episodes: mean_diff 0, all ties."""
    ours = _eval_doc(tmp_path, "ours", "--device", "cpu", "--store", store)
    ref = _eval_doc(tmp_path, "ref", "--store", store, package=jcli)
    capsys.readouterr()
    code, out, _ = _compare_out(compare_eval, ours, ref, capsys)
    assert code == 0
    doc = json.loads(out)
    assert doc["mean_diff"] == 0.0 and doc["ties"] == doc["n_episodes"] == 30


@pytest.mark.parametrize("module", [compare_eval, jcompare])
def test_compare_eval_refuses_other_episodes(store, tmp_path, capsys,
                                             module):
    a = _eval_doc(tmp_path, "s0", "--device", "cpu", "--store", store)
    b = _eval_doc(tmp_path, "s1", "--device", "cpu", "--store", store,
                  "--seed", "1")
    capsys.readouterr()
    code, out, err = _compare_out(module, a, b, capsys)
    assert code == 2 and out == ""
    assert "seed=0 vs 1" in err


@pytest.mark.parametrize("matcher", ["xla", "auto"])
def test_eval_matcher_equals_reference(store, tmp_path, capsys, matcher):
    """eval --matcher xla|auto on the CPU scores the reference's
    per-episode vector (its matcher='xla')."""
    from eov_tpu.data.store import FeatureStore as JStore

    doc_path = _eval_doc(tmp_path, matcher, "--device", "cpu", "--store",
                         store, "--matcher", matcher)
    with open(doc_path) as f:
        got = np.asarray(json.load(f)["per_episode"], np.float32)
    want = j_evaluate(JStore(store, process_index=0).to_table(),
                      JEvalConfig(n_way=3, k_shot=1, n_query=2,
                                  n_episodes=30, episodes_per_step=10,
                                  matcher="xla"))
    np.testing.assert_array_equal(got, want.per_episode)


def test_eval_matcher_on_a_table_equals_reference():
    rng = np.random.default_rng(3)
    feats = (rng.standard_normal((7, 4, 32))
             + 0.5 * rng.standard_normal((7, 1, 32))).astype(np.float32)
    counts = np.array([4, 3, 4, 2, 4, 4, 3])
    kw = dict(n_way=4, k_shot=1, n_query=1, n_episodes=40,
              episodes_per_step=16, seed=2, fusion="mean")
    want = j_evaluate(JTable(jnp.asarray(feats),
                             jnp.asarray(counts, jnp.int32)),
                      JEvalConfig(matcher="xla", **kw))
    got = evaluate(FeatureTable(torch.from_numpy(feats),
                                torch.from_numpy(counts)),
                   EvalConfig(matcher="xla", **kw))
    np.testing.assert_array_equal(got.per_episode, want.per_episode)
    with pytest.raises(ValueError, match="matcher='nope'"):
        evaluate(FeatureTable(torch.from_numpy(feats),
                              torch.from_numpy(counts)),
                 EvalConfig(matcher="nope", **kw))


def test_eval_matcher_pallas_refused_on_cpu(store):
    with pytest.raises(SystemExit, match="CUDA device only"):
        cli.main(["eval", "--device", "cpu", "--preset", "synthetic_smoke",
                  "--store", store, "--matcher", "pallas"])


def test_extract_records_with_padded_batches():
    """records= restricts the work; pad_batches pads the tail batch and the
    padded rows never reach the store: the features equal an unpadded
    run's."""
    ds = SyntheticVideoDataset(n_classes=3, clips_per_class=3, height=40,
                               width=48, seed=4)
    weights = random_state_dict("resnet18", seed=1)
    recs = ds.records[1:8]  # 7 records: batches of 3, 3 and a tail of 1
    stores = []
    for pad in (False, True):
        cfg = ExtractConfig(num_segments=2, arch="resnet18", batch_clips=3,
                            scale_size=40, crop_size=32,
                            compute_dtype="float32", deterministic=True,
                            pad_batches=pad)
        fn = make_feature_fn(weights, cfg, "cpu")
        seen = []

        def counted(x, fn=fn, seen=seen):
            seen.append(x.shape[0])
            return fn(x)
        st = MemoryFeatureStore(class_names=ds.class_names)
        stats = extract_features(ds, weights, st, cfg, feature_fn=counted,
                                 device="cpu", records=recs)
        assert stats == {"total": 7, "skipped_done": 0, "extracted": 7,
                         "failed": 0}
        assert seen == ([3, 3, 3] if pad else [3, 3, 1])
        stores.append(st.load_all())
    assert sorted(stores[0]) == sorted(r.video_id for r in recs)
    for vid, (f, label) in stores[0].items():
        np.testing.assert_allclose(stores[1][vid][0], f, rtol=1e-5,
                                   atol=1e-6)
        assert stores[1][vid][1] == label


def test_pallas_crop_off_takes_the_resize_path():
    """pallas_crop=False runs the resize route, which at the eval scale
    computes what kernel 1's route computes."""
    ds = SyntheticVideoDataset(n_classes=1, clips_per_class=1, height=40,
                               width=48, seed=0)
    rec = ds.records[0]
    clip = torch.from_numpy(ds.get_frames(rec, np.arange(2))[None])
    weights = random_state_dict("resnet18", seed=0)
    feats = [make_feature_fn(weights, ExtractConfig(
        num_segments=2, arch="resnet18", scale_size=40, crop_size=32,
        compute_dtype="float32", pallas_crop=pc), "cpu")(clip)
        for pc in (True, False)]
    torch.testing.assert_close(feats[0], feats[1], rtol=1e-5, atol=1e-5)


def test_presets_lists_the_reference_presets(capsys):
    """The same names in the same order, one line each in the reference's
    format; each description opens as the reference's does (the port's
    drop the TPU figures and notes)."""
    from eov_tpu.config import PRESETS as JPRESETS

    from eov_tpu_torch.config import PRESETS

    assert cli.main(["presets"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(JPRESETS)
    for ln, p, jp in zip(lines, PRESETS.values(), JPRESETS.values()):
        assert ln == f"{p.name:20s} {p.description}"
        assert p.description[:25] == jp.description[:25]
    assert cli.main(["presets", "--verbose"]) == 0
    out = capsys.readouterr().out
    assert '"matcher": "auto"' in out and '"pad_batches": false' in out


def test_fixtures_equal_reference(tmp_path, capsys):
    from PIL import Image

    args = ["--synthetic-classes", "2", "--synthetic-clips", "2"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert cli.main(["fixtures", "--root", ours, *args]) == 0
    assert jcli.main(["fixtures", "--root", ref, *args]) == 0
    with open(os.path.join(ours, "split.json")) as f:
        split = json.load(f)
    with open(os.path.join(ref, "split.json")) as f:
        assert split == json.load(f)
    assert len(split["splits"]["all"]) == 4
    for vid, n, _ in split["splits"]["all"]:
        names = sorted(os.listdir(os.path.join(ours, vid)))
        assert names == sorted(os.listdir(os.path.join(ref, vid)))
        assert len(names) == n
        for name in (names[0], names[-1]):
            a = np.asarray(Image.open(os.path.join(ours, vid, name)))
            b = np.asarray(Image.open(os.path.join(ref, vid, name)))
            np.testing.assert_array_equal(a, b)


def test_profile_summary_hand_built_trace(tmp_path):
    """Known kernel, memcpy and CPU intervals: busy is the union of the
    device events, idle the rest of their span, shares exact."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 105.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 130.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 160.0,
         "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 500.0},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 101.0},
    ]
    with open(tmp_path / "t.pt.trace.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    with open(tmp_path / "trace_meta.json", "w") as f:
        json.dump({"device": "cuda", "trace": "t.pt.trace.json"}, f)
    rows = profile_summary.summarize(str(tmp_path), top=2)
    # busy: [100, 115] + [130, 150] + [160, 165] = 40; span 65 -> idle 25
    assert rows[0]["device_busy_us"] == 40.0
    assert rows[0]["device_idle_us"] == 25.0
    assert rows[0]["device"] == "cuda"
    assert rows[1] == {"op": "k1", "self_us": 30.0, "avg_us": 15.0,
                       "occurrences": 2, "share_of_busy": 0.75}
    assert rows[2] == {"op": "k2", "self_us": 10.0, "avg_us": 10.0,
                       "occurrences": 1, "share_of_busy": 0.25}
    assert len(rows) == 3


def test_profile_summary_cuda_trace_without_kernels_raises(tmp_path):
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
           "dur": 5.0}]
    with open(tmp_path / "t.pt.trace.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    with open(tmp_path / "trace_meta.json", "w") as f:
        json.dump({"device": "cuda", "trace": "t.pt.trace.json"}, f)
    with pytest.raises(ValueError, match="no kernel events"):
        profile_summary.summarize(str(tmp_path))
    os.remove(tmp_path / "trace_meta.json")  # labelled by its kernels: cpu
    assert profile_summary.summarize(str(tmp_path))[0]["device"] == "cpu"


def test_profile_summary_cpu_nesting(tmp_path):
    ev = [{"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0.0,
           "dur": 10.0, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 2.0,
           "dur": 4.0, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 20.0,
           "dur": 5.0, "pid": 1, "tid": 1}]
    with open(tmp_path / "t.pt.trace.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    rows = profile_summary.summarize(str(tmp_path))
    assert rows[0] == {"device_busy_us": 15.0, "device_idle_us": 10.0,
                       "device": "cpu", "source": "cpu_op"}
    assert {r["op"]: r["self_us"] for r in rows[1:]} == {"inner": 9.0,
                                                          "outer": 6.0}


def test_trace_of_a_cli_extract_parses(tmp_path, capsys):
    tdir = str(tmp_path / "trace")
    assert cli.main(["extract", *SMALL, "--store", str(tmp_path / "s"),
                     "--trace", tdir]) == 0
    with open(os.path.join(tdir, "trace_meta.json")) as f:
        meta = json.load(f)
    assert meta["device"] == "cpu" and meta["activities"] == ["CPU"]
    rows = profile_summary.summarize(tdir, top=5)
    assert rows[0]["source"] == "cpu_op" and rows[0]["device_busy_us"] > 0
    assert 1 <= len(rows) - 1 <= 5
    assert any("conv" in r["op"] for r in rows[1:])
    capsys.readouterr()
    assert profile_summary.main([tdir, "--top", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("cpu busy ") and len(out) == 4
    # store-info runs no PyTorch op: an empty summary, not an error.
    sdir = str(tmp_path / "trace_info")
    assert cli.main(["store-info", "--store", str(tmp_path / "s"),
                     "--trace", sdir]) == 0
    assert profile_summary.summarize(sdir) == [
        {"device_busy_us": 0.0, "device_idle_us": 0.0, "device": "cpu",
         "source": "cpu_op"}]


def test_debug_nans_names_the_tensor():
    """A NaN fed through a tiny feature fn raises under debug_nans, naming
    the features; the same call without it returns them."""
    weights = random_state_dict("resnet18", seed=0)
    weights["conv1.weight"] = weights["conv1.weight"].clone()
    weights["conv1.weight"][0, 0, 0, 0] = float("nan")
    fn = make_feature_fn(weights, ExtractConfig(
        num_segments=1, arch="resnet18", scale_size=32, crop_size=32,
        compute_dtype="float32"), "cpu")
    clip = torch.zeros(1, 1, 32, 32, 3, dtype=torch.uint8) + 7
    assert not bool(torch.isfinite(fn(clip)).all())
    with debug_nans(), pytest.raises(FloatingPointError, match="features"):
        fn(clip)
    with debug_nans(), pytest.raises(FloatingPointError, match="loss"):
        check_finite("train loss", torch.tensor(float("inf")))
    check_finite("off", torch.tensor(float("nan")))  # off: no check


def test_cli_debug_nans_and_platform(tmp_path, capsys):
    """--debug-nans on a clean run changes nothing; --platform cpu picks
    the CPU; --platform tpu is refused by name."""
    store = str(tmp_path / "s")
    assert cli.main(["extract", *SMALL[2:], "--platform", "cpu",
                     "--debug-nans", "--store", store]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "extracted"] == 12
    assert cli.main(["eval", "--platform", "cpu", "--debug-nans",
                     "--preset", "synthetic_smoke", "--store", store]) == 0
    assert capsys.readouterr().out.strip().startswith("accuracy: ")
    with pytest.raises(SystemExit, match="--platform tpu"):
        cli.main(["eval", "--platform", "tpu", "--store", store])
    with pytest.raises(SystemExit, match="expected cpu, cuda or gpu"):
        cli.main(["store-info", "--platform", "xpu", "--store", store])


def test_cli_train_debug_nans(tmp_path, capsys):
    """train --debug-nans: a clean step passes the loss and gradient
    checks under anomaly detection."""
    assert cli.main(["train", "--device", "cpu", "--debug-nans", "--arch",
                     "resnet18", "--batch", "2", "--num-segments", "1",
                     "--scale-size", "36", "--crop-size", "32",
                     "--synthetic-classes", "2", "--synthetic-clips", "1",
                     "--synthetic-height", "40", "--synthetic-width",
                     "48"]) == 0
    assert "epoch 0:" in capsys.readouterr().out
    assert not torch.is_anomaly_enabled()
