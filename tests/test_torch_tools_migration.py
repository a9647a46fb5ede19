"""The port's migration and frame tools (``eov_tpu_torch/tools/``):
``make_splits``, ``extract_frames``, ``export_features`` and
``import_features``.

The reference's own cases (``tests/test_extract_frames.py``,
``test_export_features.py``, ``test_import_features.py``) run here
against the port's tools and the port's ``FeatureStore``, merged into
parametrised cases where they repeat; ``make_splits`` must regenerate the
checked-in split byte for byte; and a store crosses the two packages both
ways (the port's export read by the reference's import, and the reverse).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from eov_tpu.data.store import FeatureStore as JStore
from eov_tpu.tools.export_features import export_store as j_export
from eov_tpu.tools.import_features import import_cache as j_import

from eov_tpu_torch.data.class_splits import SPLITS_DIR
from eov_tpu_torch.data.datasets import FrameFolderDataset, load_split_txt
from eov_tpu_torch.data.store import FeatureStore
from eov_tpu_torch.eval import EvalConfig, evaluate
from eov_tpu_torch.tools import export_features as ex
from eov_tpu_torch.tools import extract_frames as ef
from eov_tpu_torch.tools import import_features as im
from eov_tpu_torch.tools import make_splits

CLASSES = ["ApplyLipstick", "HighJump", "PushUps"]


# ------------------------------------------------------------ make_splits

def test_make_splits_regenerates_checked_in_json(tmp_path, capsys):
    assert make_splits.main(["--out", str(tmp_path)]) == 0
    with open(tmp_path / "ucf101_oneshot.json", "rb") as f:
        got = f.read()
    with open(os.path.join(SPLITS_DIR, "ucf101_oneshot.json"), "rb") as f:
        assert got == f.read()
    assert "splits written" in capsys.readouterr().out


# --------------------------------------------------------- extract_frames

def _write_video(path, n_frames, h, w, seed):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    assert vw.isOpened()
    truth = []
    for i in range(n_frames):
        img = np.full((h, w, 3), 0, np.uint8)  # smooth, MJPG-friendly
        img[:, :, 0] = 40 + 12 * i
        img[:, :, 1] = rng.integers(60, 200)
        img[h // 2:, :, 2] = 180
        truth.append(img.copy())
        vw.write(img[:, :, ::-1])  # RGB -> BGR; the tool decodes to RGB
    vw.release()
    return np.stack(truth)


def test_video_roundtrip_to_framefolder(tmp_path):
    vids, out = tmp_path / "vids", tmp_path / "frames"
    truths = {}
    for cls, n in [("classA", 6), ("classB", 9)]:
        os.makedirs(vids / cls)
        truths[cls] = _write_video(str(vids / cls / f"{cls}_clip0.avi"), n,
                                   48, 64, seed=len(cls))
    res = ef.extract_all(str(vids), str(out))
    assert (res["failed"], res["extracted"]) == (0, 2)
    assert res["classes"] == ["classA", "classB"]
    split = sorted(res["split"])
    assert split == [("classA/classA_clip0", 6, 0),
                     ("classB/classB_clip0", 9, 1)]
    assert (out / "classA" / "classA_clip0" / "img_00001.jpg").exists()
    ds = FrameFolderDataset(str(out), split, res["classes"])
    rec = next(r for r in ds.records if r.video_id == "classB/classB_clip0")
    frames = ds.get_frames(rec, np.array([0, 4, 8]))
    assert frames.shape == (3, 48, 64, 3)
    # Two lossy hops (MJPG then JPEG) on smooth content.
    diff = frames.astype(int) - truths["classB"][[0, 4, 8]].astype(int)
    assert np.mean(np.abs(diff)) < 6


def test_short_side_resize_and_subsample(tmp_path):
    vids = tmp_path / "vids"
    os.makedirs(vids / "c")
    _write_video(str(vids / "c" / "v.avi"), 10, 48, 64, seed=0)
    out = tmp_path / "frames"
    res = ef.extract_all(str(vids), str(out), short_side=24, every=2,
                         max_frames=4)
    assert res["split"] == [("c/v", 4, 0)]
    from PIL import Image

    with Image.open(out / "c" / "v" / "img_00001.jpg") as img:
        assert img.size == (32, 24)  # (w, h): short side 48 -> 24


def test_decode_failure_is_skipped_not_fatal(tmp_path):
    vids = tmp_path / "vids"
    os.makedirs(vids / "c")
    _write_video(str(vids / "c" / "good.avi"), 3, 32, 32, seed=1)
    (vids / "c" / "corrupt.mp4").write_bytes(b"not a video at all")
    (vids / "loose.avi").write_bytes(b"nor this")  # class _unlabeled
    res = ef.extract_all(str(vids), str(tmp_path / "frames"))
    assert (res["extracted"], res["failed"]) == (1, 2)
    assert res["classes"] == ["_unlabeled", "c"]


def test_cli_main_writes_split_and_classes(tmp_path):
    vids = tmp_path / "vids"
    os.makedirs(vids / "c")
    _write_video(str(vids / "c" / "v.avi"), 5, 32, 32, seed=2)
    out = tmp_path / "frames"
    assert ef.main(["--videos", str(vids), "--out", str(out)]) == 0
    assert load_split_txt(str(out / "split_all.txt")) == [("c/v", 5, 0)]
    assert (out / "classes.txt").read_text().strip() == "c"


def test_frames_match_reference_tool(tmp_path):
    """The same videos through both packages' tools give the same split
    and the same JPEG bytes (same decode, same resize rounding here)."""
    from eov_tpu.tools import extract_frames as jef

    vids = tmp_path / "vids"
    os.makedirs(vids / "c")
    _write_video(str(vids / "c" / "v.avi"), 4, 48, 64, seed=3)
    a = ef.extract_all(str(vids), str(tmp_path / "a"), short_side=24)
    b = jef.extract_all(str(vids), str(tmp_path / "b"), short_side=24)
    assert a["split"] == b["split"] and a["classes"] == b["classes"]
    with open(tmp_path / "a" / "c" / "v" / "img_00004.jpg", "rb") as f:
        pa = f.read()
    with open(tmp_path / "b" / "c" / "v" / "img_00004.jpg", "rb") as f:
        assert pa == f.read()


# -------------------------------------------------------- export_features

def _make_store(root, class_names=CLASSES, dtype=None, store_cls=FeatureStore):
    store = store_cls(str(root), class_names=class_names, process_index=0,
                      dtype=dtype)
    rng = np.random.default_rng(7)
    for ci in range(3):
        for i in range(4):
            store.put(f"v{ci}_{i}", rng.normal(size=(32,)).astype(np.float32),
                      ci)
    store.flush()
    return store


def _same_store(a_root, b_root, a_cls=FeatureStore, b_cls=FeatureStore):
    a = a_cls(str(a_root), process_index=0).load_all()
    b = b_cls(str(b_root), process_index=0).load_all()
    assert a.keys() == b.keys()
    for vid in a:
        np.testing.assert_array_equal(a[vid][0], b[vid][0])
        assert a[vid][1] == b[vid][1]


def test_tree_export_roundtrips_through_import(tmp_path):
    _make_store(tmp_path / "store")
    summary = ex.export_store(str(tmp_path / "store"), str(tmp_path / "tree"))
    assert summary == {"clips": 12, "classes": 3, "format": "tree",
                       "out": str(tmp_path / "tree")}
    assert sorted(os.listdir(tmp_path / "tree")) == CLASSES
    assert os.path.exists(tmp_path / "tree" / "HighJump" / "v1_0.npy")
    im.import_cache(str(tmp_path / "tree"), str(tmp_path / "store2"),
                    class_names=CLASSES)
    _same_store(tmp_path / "store", tmp_path / "store2")
    with pytest.raises(ValueError, match="not empty"):
        ex.export_store(str(tmp_path / "store"), str(tmp_path / "tree"))


def test_npz_export_carries_labels_sidecar(tmp_path):
    import json

    _make_store(tmp_path / "store", dtype="float16")
    out = str(tmp_path / "feats.npz")
    assert ex.main(["--store", str(tmp_path / "store"), "--out", out,
                    "--format", "npz"]) == 0
    with np.load(out) as z:
        assert len(z.files) == 12
        assert z["v2_3"].dtype == np.float32  # an f16 store exports f32
    with open(tmp_path / "feats.labels.json") as f:
        labels = json.load(f)
    assert labels["v2_3"] == {"label": 2, "class_name": "PushUps"}


def test_tree_export_refuses_mangled_id_collision(tmp_path):
    f = np.ones((8,), np.float32)
    store = FeatureStore(str(tmp_path / "store"), class_names=CLASSES)
    store.put("a/b", f, 0)
    store.put("a_b", 2 * f, 0)
    store.flush()
    with pytest.raises(ValueError, match="both map to"):
        ex.export_store(str(tmp_path / "store"), str(tmp_path / "tree"))
    assert not os.path.exists(tmp_path / "tree" / CLASSES[0])
    store2 = FeatureStore(str(tmp_path / "s2"), class_names=CLASSES)
    store2.put("a/b", f, 0)
    store2.put("a_b", 2 * f, 1)  # distinct class dirs: no collision
    store2.flush()
    assert ex.export_store(str(tmp_path / "s2"),
                           str(tmp_path / "t2"))["clips"] == 2


def test_nameless_store_exports_numeric_tree(tmp_path):
    _make_store(tmp_path / "store", class_names=None)
    ex.export_store(str(tmp_path / "store"), str(tmp_path / "tree"))
    assert sorted(os.listdir(tmp_path / "tree")) == [
        "class_000", "class_001", "class_002"]
    FeatureStore(str(tmp_path / "empty"))
    assert ex.main(["--store", str(tmp_path / "empty"),
                    "--out", str(tmp_path / "t2")]) == 2
    with pytest.raises(ValueError, match="tree"):
        ex.export_store(str(tmp_path / "store"), str(tmp_path / "t3"),
                        fmt="csv")


# -------------------------------------------------------- import_features

def _feat(ci, i, d=16):
    rng = np.random.default_rng(100 * ci + i)
    f = rng.normal(size=(d,)).astype(np.float32)
    f[ci] += 12.0  # separable classes, so eval accuracy means something
    return f


def _write_class_tree(root):
    for ci, c in enumerate(CLASSES):
        os.makedirs(os.path.join(root, c))
        for i in range(4):
            np.save(os.path.join(root, c, f"v{ci}{i:02d}.npy"), _feat(ci, i))


def test_class_tree_import_and_eval(tmp_path):
    _write_class_tree(str(tmp_path / "cache"))
    summary = im.import_cache(str(tmp_path / "cache"), str(tmp_path / "s"))
    assert summary["clips"] == 12 and summary["classes"] == 3
    store = FeatureStore(str(tmp_path / "s"))
    assert store.class_names == CLASSES
    res = evaluate(store.to_table("cpu"),
                   EvalConfig(n_way=3, n_episodes=32, episodes_per_step=8))
    assert res.mean_acc > 0.9


def test_class_tree_respects_explicit_class_order(tmp_path):
    src = tmp_path / "cache"
    _write_class_tree(str(src))
    order = ["PushUps", "ApplyLipstick", "HighJump"]
    im.import_cache(str(src), str(tmp_path / "s"), class_names=order)
    store = FeatureStore(str(tmp_path / "s"))
    assert store.class_names == order
    assert store.load_all()["v000"][1] == 1
    with pytest.raises(ValueError, match="missing cache classes"):
        im.import_cache(str(src), str(tmp_path / "s2"),
                        class_names=["PushUps", "HighJump"])


@pytest.mark.parametrize("ext", ["", ".avi", ".mp4"])
def test_flat_dir_needs_split_and_maps_labels(tmp_path, ext):
    """A flat .npy directory takes its labels from --split, whose paths
    may name the source videos (their extension is stripped)."""
    src = tmp_path / "flat"
    os.makedirs(src)
    for ci in range(3):
        for i in range(2):
            np.save(str(src / f"vid_{ci}_{i}.npy"), _feat(ci, i))
    with pytest.raises(ValueError, match="--split"):
        im.import_cache(str(src), str(tmp_path / "s0"))
    split = tmp_path / "list.txt"
    split.write_text("".join(f"some/dir/vid_{ci}_{i}{ext} 30 {ci}\n"
                             for ci in range(3) for i in range(2)))
    summary = im.import_cache(str(src), str(tmp_path / "s"),
                              split=str(split))
    assert summary["clips"] == 6 and summary["clips_per_class_min"] == 2
    assert FeatureStore(str(tmp_path / "s")).load_all()["vid_2_1"][1] == 2
    np.save(str(src / "stray.npy"), _feat(0, 9))
    with pytest.raises(ValueError, match="not in the split"):
        im.import_cache(str(src), str(tmp_path / "s1"), split=str(split))


def test_dict_caches_both_keyings(tmp_path):
    by_class = {c: np.stack([_feat(ci, i) for i in range(3)])
                for ci, c in enumerate(CLASSES)}
    np.savez(str(tmp_path / "byclass.npz"), **by_class)
    summary = im.import_cache(str(tmp_path / "byclass.npz"),
                              str(tmp_path / "sc"))
    assert summary["clips"] == 9 and summary["classes"] == 3

    pkl = tmp_path / "byvid.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({f"v{ci}_{i}": _feat(ci, i)
                     for ci in range(3) for i in range(2)}, f)
    with pytest.raises(ValueError, match="allow-pickle"):
        im.import_cache(str(pkl), str(tmp_path / "sv0"), split="x")
    split = tmp_path / "list.txt"
    split.write_text("".join(f"v{ci}_{i} 30 {ci}\n"
                             for ci in range(3) for i in range(2)))
    assert im.import_cache(str(pkl), str(tmp_path / "sv"), split=str(split),
                           allow_pickle=True)["clips"] == 6
    # With --split, 2-D values are per-video features that refuse, not a
    # class-keyed dict.
    with open(pkl, "wb") as f:
        pickle.dump({"v0_0": np.stack([_feat(0, 0), _feat(0, 1)])}, f)
    split.write_text("v0_0 30 0\n")
    with pytest.raises(ValueError, match="1-D"):
        im.import_cache(str(pkl), str(tmp_path / "sv2"), split=str(split),
                        allow_pickle=True)


def test_torch_pt_caches_both_keyings_and_trust_gate(tmp_path):
    pt = tmp_path / "byvid.pt"
    torch.save({f"v{ci}_{i}": torch.from_numpy(_feat(ci, i))
                for ci in range(3) for i in range(2)}, str(pt))
    split = tmp_path / "list.txt"
    split.write_text("".join(f"Class{ci}/v{ci}_{i}.avi 30 {ci}\n"
                             for ci in range(3) for i in range(2)))
    assert im.import_cache(str(pt), str(tmp_path / "sv"),
                           split=str(split))["clips"] == 6
    data = FeatureStore(str(tmp_path / "sv")).load_all()
    np.testing.assert_allclose(data["v2_1"][0], _feat(2, 1), rtol=1e-6)
    assert data["v2_1"][1] == 2

    pth = tmp_path / "byclass.pth"
    torch.save({c: torch.from_numpy(np.stack([_feat(ci, i)
                                              for i in range(3)]))
                for ci, c in enumerate(CLASSES)}, str(pth))
    summary = im.import_cache(str(pth), str(tmp_path / "sc"))
    assert summary["clips"] == 9 and summary["classes"] == 3

    # numpy values: the restricted unpickler refuses them -> --allow-pickle.
    ptn = tmp_path / "np.pt"
    torch.save({f"v{ci}_{i}": _feat(ci, i)
                for ci in range(3) for i in range(2)}, str(ptn))
    with pytest.raises(ValueError, match="allow-pickle"):
        im.import_cache(str(ptn), str(tmp_path / "sn0"), split=str(split))
    assert not os.path.exists(tmp_path / "sn0")
    assert im.import_cache(str(ptn), str(tmp_path / "sn"), split=str(split),
                           allow_pickle=True)["clips"] == 6


def test_dict_keys_with_media_extensions_match_split(tmp_path):
    np.savez(str(tmp_path / "byvid.npz"),
             **{f"Cls{ci}/v_{ci}_{i}.avi": _feat(ci, i)
                for ci in range(2) for i in range(2)})
    split = tmp_path / "list.txt"
    split.write_text("".join(f"Cls{ci}/v_{ci}_{i}.avi 30 {ci}\n"
                             for ci in range(2) for i in range(2)))
    summary = im.import_cache(str(tmp_path / "byvid.npz"),
                              str(tmp_path / "s"), split=str(split))
    assert summary["clips"] == 4 and summary["classes"] == 2
    assert FeatureStore(str(tmp_path / "s")).load_all()["v_1_0"][1] == 1


@pytest.mark.parametrize("layout", ["class_tree", "dict_keys"])
def test_duplicate_video_ids_refuse(tmp_path, layout):
    """Two entries that normalize to one id refuse instead of last-wins."""
    if layout == "class_tree":
        src = tmp_path / "cache"
        _write_class_tree(str(src))
        np.save(str(src / CLASSES[1] / "v000.npy"), _feat(1, 0))
        kw = {}
    else:
        src = tmp_path / "dup.npz"
        np.savez(str(src), **{"A/v_0.avi": _feat(0, 0),
                              "B/v_0.mp4": _feat(1, 0)})
        split = tmp_path / "list.txt"
        split.write_text("A/v_0.avi 30 0\nB/v_0.mp4 30 0\n")
        kw = {"split": str(split)}
    with pytest.raises(ValueError, match="more than once"):
        im.import_cache(str(src), str(tmp_path / "s0"), **kw)
    assert not os.path.exists(tmp_path / "s0")


def test_validation_failure_leaves_no_partial_store(tmp_path):
    src = tmp_path / "cache"
    _write_class_tree(str(src))
    np.save(str(src / CLASSES[2] / "zz_last.npy"), np.ones((8,), np.float32))
    with pytest.raises(ValueError, match="dim mismatch"):
        im.import_cache(str(src), str(tmp_path / "s0"))
    assert not os.path.exists(str(tmp_path / "s0" / "manifest.json"))
    os.remove(str(src / CLASSES[2] / "zz_last.npy"))
    assert im.import_cache(str(src), str(tmp_path / "s0"))["clips"] == 12


@pytest.mark.parametrize("root", ["missing", "empty", "foreign_file"])
def test_write_failure_leaves_no_partial_store(tmp_path, monkeypatch, root):
    """A failure after the store was created (here, the second shard's
    write) removes what the import wrote, and only that: a root the call
    made goes, a root that was there stays with what it held, and the next
    import into it succeeds."""
    _write_class_tree(str(tmp_path / "cache"))
    kept = []
    if root != "missing":
        os.makedirs(tmp_path / "s")
    if root == "foreign_file":
        (tmp_path / "s" / "notes.txt").write_text("mine")
        kept = ["notes.txt"]
    monkeypatch.setattr(im, "_FLUSH_EVERY", 5)
    real_flush, calls = FeatureStore.flush, []

    def flaky(self):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk full")
        return real_flush(self)

    monkeypatch.setattr(FeatureStore, "flush", flaky)
    with pytest.raises(OSError, match="disk full"):
        im.import_cache(str(tmp_path / "cache"), str(tmp_path / "s"))
    if root == "missing":
        assert not os.path.exists(tmp_path / "s")
    else:
        assert sorted(os.listdir(tmp_path / "s")) == kept
    assert im.import_cache(str(tmp_path / "cache"),
                           str(tmp_path / "s"))["clips"] == 12


@pytest.mark.parametrize("case,match", [
    ("dim_mismatch", "dim mismatch"), ("mixed_layout", "mixes"),
    ("existing_store", "already exists"), ("non_finite", "NaN"),
    ("empty_dir", "no .npy"), ("unknown_file", "unrecognized"),
    ("too_few_classes", "--classes lists")])
def test_refusals(tmp_path, case, match):
    src = tmp_path / "cache"
    _write_class_tree(str(src))
    kw = {}
    if case == "dim_mismatch":
        np.save(str(src / CLASSES[0] / "odd.npy"), np.ones((8,), np.float32))
    elif case == "mixed_layout":
        np.save(str(src / "top.npy"), _feat(0, 0))
    elif case == "existing_store":
        im.import_cache(str(src), str(tmp_path / "store"))
    elif case == "non_finite":
        np.save(str(src / CLASSES[0] / "nan.npy"),
                np.full((16,), np.nan, np.float32))
    elif case == "empty_dir":
        src = tmp_path / "empty"
        os.makedirs(src)
    elif case == "unknown_file":
        src = tmp_path / "feats.csv"
        src.write_text("1,2\n")
    else:
        flat = tmp_path / "flat"
        os.makedirs(flat)
        np.save(str(flat / "a.npy"), _feat(0, 0))
        np.save(str(flat / "b.npy"), _feat(2, 0))
        split = tmp_path / "list.txt"
        split.write_text("a 30 0\nb 30 2\n")
        src, kw = flat, {"split": str(split), "class_names": ["x", "y"]}
    with pytest.raises(ValueError, match=match):
        im.import_cache(str(src), str(tmp_path / "store"), **kw)


def test_cli_main_and_f16_roundtrip(tmp_path, capsys):
    src = tmp_path / "cache"
    _write_class_tree(str(src))
    assert im.main(["--src", str(src), "--store", str(tmp_path / "s"),
                    "--store-dtype", "float16"]) == 0
    out = capsys.readouterr().out
    assert '"clips": 12' in out and '"dtype": "float16"' in out
    data = FeatureStore(str(tmp_path / "s")).load_all()
    np.testing.assert_allclose(data["v000"][0], _feat(0, 0), rtol=2e-3,
                               atol=2e-3)
    assert im.main(["--src", str(tmp_path / "nothere"),
                    "--store", str(tmp_path / "s2")]) == 2


@pytest.mark.parametrize("quant,want,recorded", [
    (None, "unknown", (None, False)), ("int8", "int8", ("int8", True)),
    ("off", "off", (None, True))])
def test_import_quant_provenance_declaration(tmp_path, quant, want,
                                             recorded):
    src = tmp_path / "cache"
    _write_class_tree(str(src))
    summary = im.import_cache(str(src), str(tmp_path / "s"), quant=quant)
    assert summary["quant"] == want
    assert FeatureStore(str(tmp_path / "s")).recorded_quant() == recorded
    argv = ["--src", str(src), "--store", str(tmp_path / "cli")]
    assert im.main(argv + (["--quant", quant] if quant else [])) == 0
    assert FeatureStore(str(tmp_path / "cli")).recorded_quant() == recorded


# ------------------------------------------------ across the two packages

@pytest.mark.parametrize("fmt", ["tree", "npz"])
def test_port_export_imports_in_reference(tmp_path, fmt):
    """The port's export, read by the reference's import, holds the port
    store's features and labels bit for bit."""
    _make_store(tmp_path / "store")
    out = str(tmp_path / ("tree" if fmt == "tree" else "feats.npz"))
    ex.export_store(str(tmp_path / "store"), out, fmt=fmt)
    if fmt == "tree":
        j_import(out, str(tmp_path / "j"), class_names=CLASSES)
    else:
        import json

        with open(tmp_path / "feats.labels.json") as f:
            labels = json.load(f)
        split = tmp_path / "list.txt"
        split.write_text("".join(f"{v} 1 {d['label']}\n"
                                 for v, d in labels.items()))
        j_import(out, str(tmp_path / "j"), split=str(split),
                 class_names=CLASSES)
    _same_store(tmp_path / "store", tmp_path / "j", b_cls=JStore)


def test_reference_export_imports_in_port(tmp_path):
    """The reference's export, read by the port's import, holds the
    reference store's features and labels bit for bit."""
    _make_store(tmp_path / "store", store_cls=JStore)
    j_export(str(tmp_path / "store"), str(tmp_path / "tree"))
    im.import_cache(str(tmp_path / "tree"), str(tmp_path / "t"),
                    class_names=CLASSES)
    _same_store(tmp_path / "store", tmp_path / "t", a_cls=JStore)
