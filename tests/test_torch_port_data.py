"""The port's real-data path against the JAX reference, on the CPU: EOVC
shards (both writers, both readers, the native loader), frame folders,
video files, split files, class splits, the packer, the pooled extraction
with its buffer ring, and the CLI's dataset flags.

Frames are made with numpy from seeds; files are written in the test's tmp
directory (JPEGs with PIL, an mp4 with cv2, as tests/test_video_files.py
writes one).
"""

import argparse
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from eov_tpu.data import class_splits as j_cs
from eov_tpu.data import datasets as j_ds
from eov_tpu.extract import ExtractConfig as JExtractConfig
from eov_tpu.extract import extract_features as j_extract
from eov_tpu.data.store import FeatureStore as JStore
from eov_tpu.runtime import eovc as j_eovc
from eov_tpu.tools.pack_eovc import pack as j_pack
from eov_tpu.tools.port_torch import port_resnet_state_dict

from eov_tpu_torch import cli, extract
from eov_tpu_torch.data import class_splits as cs
from eov_tpu_torch.data import datasets as ds_mod
from eov_tpu_torch.data.store import FeatureStore, MemoryFeatureStore
from eov_tpu_torch.models import get_arch
from eov_tpu_torch.models.resnet import random_state_dict
from eov_tpu_torch.runtime import eovc, native
from eov_tpu_torch.tools import pack_eovc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clips(seed, n=3, h=24, w=34):
    """[(video_id, label, uint8 frames [F, h, w, 3])] from a seed."""
    rng = np.random.default_rng(seed)
    return [(f"clip_{i}", i % 2,
             rng.integers(0, 256, (int(rng.integers(4, 8)), h, w, 3),
                          dtype=np.uint8)) for i in range(n)]


def _jpegs(frames):
    import io

    from PIL import Image

    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def _write(writer_cls, path, clips, codec):
    h, w = clips[0][2].shape[1:3]
    with writer_cls(path, h, w, codec=codec) as wr:
        for vid, label, frames in clips:
            wr.add_clip(vid, label,
                        _jpegs(frames) if codec == "jpeg" else frames)


# ------------------------------------------------------------------- EOVC

@pytest.mark.parametrize("codec", ["raw", "jpeg"])
def test_eovc_shards_cross_read(tmp_path, codec):
    """The two writers write the same bytes; each package's reader reads the
    other's shard as its own, and the port's native loader agrees with its
    python reader (RAW bit for bit; JPEG within libjpeg's rounding against
    PIL's)."""
    clips = _clips(1)
    ours, theirs = str(tmp_path / "port.eovc"), str(tmp_path / "ref.eovc")
    _write(eovc.EovcWriter, ours, clips, codec)
    _write(j_eovc.EovcWriter, theirs, clips, codec)
    assert filecmp.cmp(ours, theirs, shallow=False)
    for path in (ours, theirs):
        mine, ref = eovc.EovcReader(path), j_eovc.EovcReader(path)
        assert [(c.video_id, c.label, c.n_frames) for c in mine.clips] == [
            (v, lab, len(f)) for v, lab, f in clips]
        for i, (_, _, frames) in enumerate(clips):
            idx = list(range(len(frames)))[::-1]
            got = mine.load_frames(i, idx)
            np.testing.assert_array_equal(got, ref.load_frames(i, idx))
            if codec == "raw":
                np.testing.assert_array_equal(got, frames[idx])
    assert native.native_available(), native.build_error()
    nl = native.NativeClipLoader(theirs, n_threads=2)
    py = eovc.EovcReader(theirs)
    idx = np.array([[0, 2, 1], [3, 0, 2], [1, 1, 0]], np.int32)
    got = nl.load_batch([2, 0, 1], idx)
    want = np.stack([py.load_frames(c, i) for c, i in zip([2, 0, 1], idx)])
    if codec == "raw":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(int) - want).max() <= 2
    assert [nl.clip_info(i) for i in range(3)] == [
        (v, lab, len(f)) for v, lab, f in clips]
    out = np.empty_like(got)
    assert nl.load_batch([2, 0, 1], idx, out=out) is out
    np.testing.assert_array_equal(out, got)
    nl.submit([0], idx[1:2])
    nl.submit([1], idx[2:3])
    np.testing.assert_array_equal(nl.wait()[0], got[1])
    np.testing.assert_array_equal(nl.wait()[0], got[2])
    with pytest.raises(ValueError):
        nl.load_batch([0, 1], idx)
    nl.close()


def test_eovc_dataset_matches_reference(tmp_path):
    """A shard directory with the sidecar: records, class names, frames and
    the pooled get_batch (into a caller's buffer, across shards, in record
    order) equal the reference's, with the native loader and the python
    reader."""
    src = ds_mod.SyntheticVideoDataset(n_classes=3, clips_per_class=3,
                                       height=32, width=44, min_frames=6,
                                       max_frames=9, seed=4)
    root = str(tmp_path / "shards")
    assert pack_eovc.pack(src, root, storage_short_side=None,
                          clips_per_shard=4) == 9
    assert sorted(os.listdir(root)) == ["classes.json", "shard_00000.eovc",
                                        "shard_00001.eovc",
                                        "shard_00002.eovc"]
    ref = j_ds.EovcVideoDataset(root)
    for prefer in (True, False):
        got = ds_mod.EovcVideoDataset(root, prefer_native=prefer)
        assert got.is_native == prefer
        assert got.class_names == ref.class_names == src.class_names
        assert got.records == [ds_mod.VideoRecord(*(r.video_id, r.num_frames,
                                                    r.label))
                               for r in ref.records]
        recs = [got.records[i] for i in (8, 0, 5, 1)]
        idx = np.stack([np.arange(4) % r.num_frames for r in recs]).astype(
            np.int32)
        out = np.zeros((4, 4, 32, 44, 3), np.uint8)
        assert got.get_batch(recs, idx, out=out) is out
        np.testing.assert_array_equal(
            out, ref.get_batch([ref.records[i] for i in (8, 0, 5, 1)], idx))
        for r, i in zip(recs, idx):
            np.testing.assert_array_equal(got.get_frames(r, i),
                                          src.get_frames(r, i))
    with pytest.raises(ValueError, match="jpeg_scale_denom"):
        ds_mod.EovcVideoDataset(root, prefer_native=False,
                                jpeg_scale_denom=2)


def test_native_loader_build_and_override(tmp_path, monkeypatch):
    """The loader builds into build/native/ (named by the source's hash),
    never into native/; EOV_NATIVE_LIB names another build to load, and a
    missing one is reported, not raised."""
    assert native.native_available()
    path = native._lib_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.BUILD_DIR == type(native.BUILD_DIR)(ROOT) / "build" / "native"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("EOV_NATIVE_LIB", str(tmp_path / "missing.so"))
    assert not native.native_available()
    assert "missing.so" in native.build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeClipLoader(str(tmp_path / "x.eovc"))
    monkeypatch.setenv("EOV_NATIVE_LIB", str(path))
    assert native.native_available() and native.build_error() is None


@pytest.mark.parametrize("rel", [
    "native/clip_loader.cc", "splits/README.md", "splits/ucf101_classes.txt",
    "splits/ucf101_oneshot.json"])
def test_copies_are_byte_equal(rel):
    """The port keeps its own copies of the loader's source and the split
    documents; they stay byte-equal to the reference's."""
    ref = os.path.join(ROOT, rel if rel.startswith("native") else
                       os.path.join("eov_tpu", rel))
    assert filecmp.cmp(os.path.join(ROOT, "eov_tpu_torch", rel), ref,
                       shallow=False)


# ------------------------------------------------- frame folders, videos

@pytest.mark.parametrize("backend", ["pil", "cv2"])
def test_frame_folder_matches_reference(tmp_path, backend):
    from PIL import Image

    rng = np.random.default_rng(2)
    split = []
    for v in range(3):
        n = 3 + v
        os.makedirs(tmp_path / f"vid{v}")
        for t in range(n):
            Image.fromarray(rng.integers(0, 256, (20, 28, 3), np.uint8)).save(
                tmp_path / f"vid{v}" / f"img_{t + 1:05d}.jpg", quality=90)
        split.append((f"vid{v}", n, v % 2))
    got = ds_mod.FrameFolderDataset(str(tmp_path), split, ["a", "b"],
                                    backend=backend)
    ref = j_ds.FrameFolderDataset(str(tmp_path), split, ["a", "b"],
                                  backend=backend)
    assert [tuple(r.__dict__.values()) for r in got.records] == split
    for r in got.records:
        idx = np.arange(r.num_frames)[::-1]
        np.testing.assert_array_equal(got.get_frames(r, idx),
                                      ref.get_frames(r, idx))


def test_video_files_match_reference(tmp_path):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path / "videos"
    for c in ("class_a", "class_b"):
        os.makedirs(root / c)
        for j in range(2):
            wr = cv2.VideoWriter(str(root / c / f"v{j}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 24))
            if not wr.isOpened():
                pytest.skip("cv2.VideoWriter cannot encode mp4 on this box")
            for t in range(8 + 2 * j):
                wr.write(np.full((24, 32, 3), (t * 16) % 240, np.uint8))
            wr.release()
    got = ds_mod.VideoFileDataset(str(root))
    ref = j_ds.VideoFileDataset(str(root))
    assert got.class_names == ref.class_names == ["class_a", "class_b"]
    assert [(r.video_id, r.num_frames, r.label) for r in got.records] == [
        (r.video_id, r.num_frames, r.label) for r in ref.records]
    idx = np.array([[0, 3, 7]] * 4)
    np.testing.assert_array_equal(got.get_batch(got.records, idx),
                                  ref.get_batch(ref.records, idx))
    only = ds_mod.VideoFileDataset(str(root), only_classes=["class_b"])
    assert only.class_names == ["class_b"] and len(only.records) == 2
    with pytest.raises(FileNotFoundError):
        ds_mod.VideoFileDataset(str(root), only_classes=["nope"])


# ------------------------------------------------------------ splits

def test_split_files_round_trip_both_ways(tmp_path):
    split = [("a/v0", 12, 0), ("b c/v1", 7, 1), ("b c/v2", 30, 1)]
    for save, load in ((ds_mod.save_split_txt, j_ds.load_split_txt),
                       (j_ds.save_split_txt, ds_mod.load_split_txt)):
        save(str(tmp_path / "s.txt"), split)
        assert load(str(tmp_path / "s.txt")) == split
    names, splits = ["a", "b c"], {"all": [list(s) for s in split]}
    for save, load in ((ds_mod.save_split_json, j_ds.load_split_json),
                       (j_ds.save_split_json, ds_mod.load_split_json)):
        save(str(tmp_path / "s.json"), names, splits)
        assert load(str(tmp_path / "s.json")) == {"class_names": names,
                                                  "splits": splits}


def test_class_splits_match_reference(tmp_path):
    names = cs.load_class_list(os.path.join(cs.SPLITS_DIR,
                                            "ucf101_classes.txt"))
    assert len(names) == 101
    for seed in (0, 3):
        assert cs.make_class_split(names, 70, 10, 21, seed=seed) == \
            j_cs.make_class_split(names, 70, 10, 21, seed=seed)
    doc = cs.load_class_split(os.path.join(cs.SPLITS_DIR,
                                           "ucf101_oneshot.json"))
    assert doc == cs.make_class_split(names, 70, 10, 21, seed=0,
                                      protocol=doc["protocol"])
    cs.save_class_split(str(tmp_path / "a.json"), doc)
    j_cs.save_class_split(str(tmp_path / "b.json"), doc)
    assert filecmp.cmp(tmp_path / "a.json", tmp_path / "b.json",
                       shallow=False)
    bad = {"class_splits": {"train": ["x", "y"], "test": ["y"]}}
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="multiple splits"):
        cs.load_class_split(str(tmp_path / "bad.json"))
    with pytest.raises(ValueError):
        cs.make_class_split(names, 70, 10, 20)

    split = [(f"v{i}", 10 + i, i % 5) for i in range(15)]
    cn = [f"c{i}" for i in range(5)]
    keep = ["c3", "c1"]
    assert cs.filter_split_by_classes(split, cn, keep) == \
        j_cs.filter_split_by_classes(split, cn, keep)
    base = ds_mod.SyntheticVideoDataset(n_classes=5, clips_per_class=2,
                                        height=8, width=8)
    jbase = j_ds.SyntheticVideoDataset(n_classes=5, clips_per_class=2,
                                       height=8, width=8)
    got = cs.filter_dataset_by_classes(base, base.class_names[3:0:-2])
    ref = j_cs.filter_dataset_by_classes(jbase, jbase.class_names[3:0:-2])
    assert got.class_names == ref.class_names
    assert [(r.video_id, r.num_frames, r.label) for r in got.records] == [
        (r.video_id, r.num_frames, r.label) for r in ref.records]
    assert not hasattr(got, "get_batch")  # the base has none


class _Uninspectable:
    """A callable whose signature cannot be read (as a C callable's)."""

    def __init__(self, fn):
        self._fn = fn

    @property
    def __signature__(self):
        raise ValueError("no signature")

    def __call__(self, *a, **k):
        return self._fn(*a, **k)


def test_class_filter_mirrors_pooled_get_batch():
    """The filtered view exposes get_batch only when its base has one, with
    the base's out= support, and stays opaque over an opaque base."""
    base = ds_mod.SyntheticVideoDataset(n_classes=3, clips_per_class=2,
                                        height=8, width=8)

    class WithOut:
        records, class_names = base.records, base.class_names

        def get_batch(self, records, indices, out=None):
            return out

    class NoOut(WithOut):
        def get_batch(self, records, indices):
            return "no-out"

    class Opaque(WithOut):
        get_batch = _Uninspectable(lambda records, indices, **k: k)

    keep = base.class_names[:2]
    acc = ds_mod.get_batch_accepts_out
    assert acc(cs.filter_dataset_by_classes(WithOut(), keep).get_batch)
    assert acc(cs.filter_dataset_by_classes(NoOut(), keep).get_batch) is False
    opaque = cs.filter_dataset_by_classes(Opaque(), keep).get_batch
    assert acc(opaque) is None
    assert opaque([], None, out=5) == {"out": 5}
    assert acc(cs.filter_dataset_by_classes(NoOut(), keep).get_batch) == \
        j_ds.get_batch_accepts_out(
            j_cs.filter_dataset_by_classes(NoOut(), keep).get_batch)


# --------------------------------------------------------------- packing

def test_pack_matches_reference(tmp_path):
    """The port's packer against the reference's on 30x40 frames packed at
    short side 32: the same container, sidecar and frames, each value
    within one step of the reference's (the resize's float32 sums run in
    another order, so a value within rounding of a half may round apart)."""
    src = ds_mod.SyntheticVideoDataset(n_classes=2, clips_per_class=2,
                                       height=30, width=40, min_frames=3,
                                       max_frames=5, seed=6)
    jsrc = j_ds.SyntheticVideoDataset(n_classes=2, clips_per_class=2,
                                      height=30, width=40, min_frames=3,
                                      max_frames=5, seed=6)
    ours, theirs = str(tmp_path / "p.eovc"), str(tmp_path / "r.eovc")
    pack_eovc.pack(src, ours, storage_short_side=32)
    j_pack(jsrc, theirs, storage_short_side=32)
    assert filecmp.cmp(ours + ".classes.json", theirs + ".classes.json",
                       shallow=False)
    a, b = eovc.EovcReader(ours), j_eovc.EovcReader(theirs)
    assert (a.h, a.w) == (b.h, b.w) == (32, 42)
    for i, c in enumerate(a.clips):
        assert (c.video_id, c.label, c.n_frames) == (
            b.clips[i].video_id, b.clips[i].label, b.clips[i].n_frames)
        idx = range(c.n_frames)
        diff = a.load_frames(i, idx).astype(int) - b.load_frames(i, idx)
        assert np.abs(diff).max() <= 1
    x = np.random.default_rng(0).integers(0, 256, (2, 30, 40, 3), np.uint8)
    assert pack_eovc.resize_short_side_np(x, 30) is x  # already there
    assert pack_eovc.main(["--out", str(tmp_path / "cli"), "--synthetic-"
                           "classes", "2", "--synthetic-clips", "1",
                           "--synthetic-height", "24", "--synthetic-width",
                           "30", "--short-side", "24", "--clips-per-shard",
                           "1", "--codec", "jpeg"]) == 0
    got = ds_mod.EovcVideoDataset(str(tmp_path / "cli"))
    assert len(got.records) == 2 and got.class_names == [
        "synthetic_class_000", "synthetic_class_001"]


# ------------------------------------------------------------ extraction

class _PerRecord:
    """A dataset's records and get_frames without its pooled get_batch."""

    def __init__(self, ds):
        self.records, self.class_names = ds.records, ds.class_names
        self.get_frames = ds.get_frames


def test_extract_pooled_equals_per_record_and_reference(tmp_path):
    """extract_features over a small RAW shard: the pooled path (one
    get_batch per batch into ring buffers) gives the per-record path's
    features bit for bit, and both agree with the reference's
    extract_features on the same shard and weights (per-clip cosine
    >= 0.99999, the f32 bar)."""
    src = ds_mod.SyntheticVideoDataset(n_classes=3, clips_per_class=3,
                                       height=40, width=48, min_frames=6,
                                       max_frames=10, seed=2)
    path = str(tmp_path / "s.eovc")
    pack_eovc.pack(src, path, storage_short_side=None)
    sd = random_state_dict("resnet18", seed=0)  # the reference's width
    base = dict(arch="resnet18", num_segments=3, batch_clips=4,
                scale_size=40, crop_size=32, compute_dtype="float32")
    cfg = extract.ExtractConfig(**base)
    ds = ds_mod.EovcVideoDataset(path)
    fn = extract.make_feature_fn(sd, cfg, "cpu")
    feats = {}
    for name, d in (("pooled", ds), ("record", _PerRecord(ds))):
        st = MemoryFeatureStore(class_names=ds.class_names)
        stats = extract.extract_features(d, None, st, cfg, feature_fn=fn,
                                         device="cpu")
        report = stats.pop("report")
        assert stats == {"total": 9, "skipped_done": 0, "extracted": 9,
                         "failed": 0}
        assert report["counters"]["eovc.clips"] == 9
        feats[name] = st.load_all()
    for vid, (f, _) in feats["pooled"].items():
        assert torch.equal(torch.from_numpy(f),
                           torch.from_numpy(feats["record"][vid][0]))
    stage_sizes, bottleneck = get_arch("resnet18")
    variables = port_resnet_state_dict(
        {k: v.numpy() for k, v in sd.items()}, stage_sizes=stage_sizes,
        bottleneck=bottleneck)
    jstore = JStore(str(tmp_path / "ref"), class_names=ds.class_names,
                    process_index=0)
    j_extract(j_ds.EovcVideoDataset(path), variables, jstore,
              JExtractConfig(deterministic=True, **base))
    want = jstore.load_all()
    assert set(want) == set(feats["pooled"])
    for vid, (f, label) in feats["pooled"].items():
        w = want[vid][0]
        cos = float(f @ w / np.linalg.norm(f) / np.linalg.norm(w))
        assert cos >= 0.99999, (vid, cos)
        assert label == want[vid][1]


def _ring_dataset(calls, *, with_out=True, raise_type=False):
    base = ds_mod.SyntheticVideoDataset(n_classes=2, clips_per_class=6,
                                        height=16, width=20, seed=0,
                                        name="ring")

    def frames(records, idx):
        return np.stack([base.get_frames(r, i) for r, i in zip(records, idx)])

    class Pooled:
        records, class_names = base.records, base.class_names

        def get_frames(self, rec, idx):
            return base.get_frames(rec, idx)

    if raise_type:
        def get_batch(self, records, idx, out=None):
            raise TypeError("internal argtype bug")
    elif with_out:
        def get_batch(self, records, idx, out=None):
            calls.append(out)
            if out is None:
                return frames(records, idx)
            out[...] = frames(records, idx)
            return out
    else:
        def get_batch(self, records, idx):
            calls.append(None)
            return frames(records, idx)
    Pooled.get_batch = get_batch
    return Pooled()


def _cheap(frames_u8):
    return frames_u8.float().mean(dim=(2, 3)).reshape(frames_u8.shape[0], -1)


def test_pooled_buffer_ring_cycles():
    """Once the batch shape is known, every batch decodes into a ring
    buffer, and buffers come back after their features materialize: four
    batches reuse at most the overlap depth of buffers."""
    calls = []
    ds = _ring_dataset(calls)
    extract._HOST_BUFS.pop((3, 2, 16, 20, 3), None)
    stats = extract.extract_features(
        ds, None, MemoryFeatureStore(class_names=ds.class_names),
        extract.ExtractConfig(num_segments=2, batch_clips=3),
        feature_fn=_cheap, device="cpu")
    assert stats["extracted"] == 12
    assert calls[0] is None and all(c is not None for c in calls[1:])
    assert len(calls) == 4
    assert len(extract._HOST_BUFS[(3, 2, 16, 20, 3)]) <= extract._HOST_BUFS_CAP


def test_buffer_ring_capped_and_lru():
    cap, shapes = extract._HOST_BUFS_SHAPES, [(5, 5, i) for i in range(6)]
    for s in shapes:
        extract._HOST_BUFS.pop(s, None)
    try:
        for _ in range(extract._HOST_BUFS_CAP + 2):
            extract._put_buf(np.zeros(shapes[0], np.uint8))
        assert len(extract._HOST_BUFS[shapes[0]]) == extract._HOST_BUFS_CAP
        for s in shapes[1:cap]:
            extract._put_buf(np.zeros(s, np.uint8))
        assert extract._take_buf(shapes[0]) is not None  # now most recent
        extract._put_buf(np.zeros(shapes[cap], np.uint8))
        assert shapes[0] in extract._HOST_BUFS
        assert shapes[1] not in extract._HOST_BUFS
        assert len(extract._HOST_BUFS) <= cap
        assert extract._take_buf((5, 5, 99)) is None
    finally:
        for s in shapes:
            extract._HOST_BUFS.pop(s, None)


def test_pooled_outless_and_internal_typeerror(caplog):
    """An out-less get_batch runs pooled once per batch; a TypeError from
    inside an out-accepting one falls back per record, loudly."""
    calls = []
    ds = _ring_dataset(calls, with_out=False)
    cfg = extract.ExtractConfig(num_segments=2, batch_clips=4)
    stats = extract.extract_features(
        ds, None, MemoryFeatureStore(class_names=ds.class_names), cfg,
        feature_fn=_cheap, device="cpu")
    assert stats["extracted"] == 12 and calls == [None] * 3
    bad = _ring_dataset([], raise_type=True)
    with caplog.at_level("WARNING", logger="eov_tpu_torch.extract"):
        stats = extract.extract_features(
            bad, None, MemoryFeatureStore(class_names=bad.class_names), cfg,
            feature_fn=_cheap, device="cpu")
    assert stats["extracted"] == 12
    assert any("internal argtype bug" in r.message for r in caplog.records)


def test_pooled_probe_settles_outless(caplog):
    """An un-introspectable get_batch that rejects out= costs one probe:
    that batch retries out-less and the out-less form holds for the run."""
    calls = []
    ds = _ring_dataset(calls, with_out=False)
    inner = type(ds).get_batch.__get__(ds)
    seen = []

    def strict(records, idx, **kw):
        seen.append(sorted(kw))
        if kw:
            raise TypeError("unexpected keyword argument 'out'")
        return inner(records, idx)

    ds.get_batch = _Uninspectable(strict)
    with caplog.at_level("WARNING", logger="eov_tpu_torch.extract"):
        stats = extract.extract_features(
            ds, None, MemoryFeatureStore(class_names=ds.class_names),
            extract.ExtractConfig(num_segments=2, batch_clips=4),
            feature_fn=_cheap, device="cpu")
    assert stats["extracted"] == 12 and stats["failed"] == 0
    assert seen == [["out"], [], [], []]
    assert sum("settling" in r.message for r in caplog.records) == 1


# ------------------------------------------------------------------- CLI

def _args(**kw):
    base = dict(dataset="synthetic", root=None, split=None, split_name="all",
                class_split=None, jpeg_scale_denom=1, synthetic_classes=4,
                synthetic_clips=2, synthetic_height=16, synthetic_width=20,
                seed=0)
    return argparse.Namespace(**{**base, **kw})


def test_load_dataset_each_kind(tmp_path):
    from PIL import Image

    split_doc = {"protocol": "t", "class_splits": {
        "train": ["synthetic_class_000", "synthetic_class_001"],
        "val": ["synthetic_class_002"], "test": ["synthetic_class_003"]}}
    cs.save_class_split(str(tmp_path / "cs.json"), split_doc)
    syn = cli._load_dataset(_args(class_split=f"{tmp_path}/cs.json:train"))
    assert syn.class_names == split_doc["class_splits"]["train"]
    assert len(syn.records) == 4

    shards = str(tmp_path / "sh")
    pack_eovc.pack(ds_mod.SyntheticVideoDataset(
        n_classes=4, clips_per_class=2, height=16, width=20), shards,
        storage_short_side=None, clips_per_shard=3)
    ev = cli._load_dataset(_args(dataset="eovc", root=shards,
                                 class_split=f"{tmp_path}/cs.json"))
    assert ev.class_names == ["synthetic_class_003"]  # part 'test'
    assert hasattr(ev, "get_batch") and len(ev.records) == 2

    for v in range(2):
        os.makedirs(tmp_path / "fr" / f"v{v}")
        for t in range(3):
            Image.fromarray(np.full((8, 10, 3), 40 * t, np.uint8)).save(
                tmp_path / "fr" / f"v{v}" / f"img_{t + 1:05d}.jpg")
    ds_mod.save_split_json(str(tmp_path / "fr.json"), ["x", "y"],
                           {"all": [["v0", 3, 0], ["v1", 3, 1]]})
    fr = cli._load_dataset(_args(dataset="framedir", root=str(tmp_path / "fr"),
                                 split=str(tmp_path / "fr.json")))
    assert fr.class_names == ["x", "y"] and len(fr.records) == 2
    assert fr.get_frames(fr.records[1], [2]).shape == (1, 8, 10, 3)

    cv2 = pytest.importorskip("cv2")
    os.makedirs(tmp_path / "vd" / "synthetic_class_003")
    wr = cv2.VideoWriter(str(tmp_path / "vd" / "synthetic_class_003" /
                             "a.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                         (16, 16))
    for _ in range(4):
        wr.write(np.zeros((16, 16, 3), np.uint8))
    wr.release()
    os.makedirs(tmp_path / "vd" / "other")
    vd = cli._load_dataset(_args(dataset="videodir",
                                 root=str(tmp_path / "vd"),
                                 class_split=f"{tmp_path}/cs.json:test"))
    assert vd.class_names == ["synthetic_class_003"]
    assert len(vd.records) == 1 and vd.records[0].num_frames == 4
    for kind in ("eovc", "videodir", "framedir"):
        with pytest.raises(SystemExit):
            cli._load_dataset(_args(dataset=kind))


def test_cli_extract_eovc_and_train_val_class_split(tmp_path, monkeypatch):
    """extract --dataset eovc --class-split through the CLI on the CPU, and
    train --val-class-split: the meta-val set is the split's 'val' part
    (a bare path defaults to it), with the --val-* flags passed through."""
    shards = str(tmp_path / "sh")
    pack_eovc.main(["--out", shards, "--synthetic-classes", "4",
                    "--synthetic-clips", "2", "--synthetic-height", "24",
                    "--synthetic-width", "30", "--short-side", "24",
                    "--clips-per-shard", "5"])
    split = cs.make_class_split([f"synthetic_class_{i:03d}"
                                 for i in range(4)], 2, 1, 1)
    cs.save_class_split(str(tmp_path / "cs.json"), split)
    assert cli.main(["extract", "--device", "cpu", "--preset",
                     "synthetic_smoke", "--arch", "resnet18", "--scale-size",
                     "24", "--crop-size", "24", "--dataset", "eovc",
                     "--root", shards, "--class-split",
                     f"{tmp_path}/cs.json:test", "--store",
                     str(tmp_path / "st")]) == 0
    st = FeatureStore(str(tmp_path / "st"))
    assert st.class_names == split["class_splits"]["test"]
    assert len(st.load_all()) == 2

    got = {}

    def fake_run(cfg, dataset, **kw):
        got.update(kw, dataset=dataset, cfg=cfg)
        return {}

    monkeypatch.setattr(cli, "run_training", fake_run)
    assert cli.main(["train", "--device", "cpu", "--dataset", "eovc",
                     "--root", shards, "--class-split",
                     f"{tmp_path}/cs.json:train", "--val-class-split",
                     f"{tmp_path}/cs.json", "--val-episodes", "7",
                     "--val-n-way", "1", "--val-segments", "2"]) == 0
    assert got["dataset"].class_names == split["class_splits"]["train"]
    assert got["cfg"].num_classes == 2
    assert got["val_dataset"].class_names == split["class_splits"]["val"]
    assert (got["val_episodes"], got["val_n_way"], got["val_segments"]) == (
        7, 1, 2)
    assert cli._val_split_spec("a.json:") == "a.json:val"
    assert cli._val_split_spec("a.json:test") == "a.json:test"
