"""The port's four deployment benches on the CPU at tiny sizes: fused vs
cached eval, classify, episode and decode.

Each prints the reference benches' metric and detail keys (as
``tests/test_bench.py`` holds the reference's): one JSON line per run, one
per path for decode. The fused-vs-cached parity rail is exact in f32 on
the CPU. The times are CPU times here and say nothing of the card.
"""

import json

import pytest
import torch

from eov_tpu_torch.bench import classify, decode, episode, fused_eval


def _lines(main, capsys) -> list[dict]:
    main()
    return [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]


def _env(monkeypatch, env: dict) -> None:
    for k, v in env.items():
        monkeypatch.setenv(k, v)


FUSED = {"EOV_BENCH_DEVICE": "cpu", "EOV_FUSED_CLASSES": "6",
         "EOV_FUSED_CLIPS": "4", "EOV_FUSED_FRAMES": "2",
         "EOV_FUSED_HW": "64x80", "EOV_FUSED_EPS_STEP": "4",
         "EOV_FUSED_ARCH": "resnet18", "EOV_FUSED_CHUNK": "8",
         "EOV_FUSED_ITERS": "1", "EOV_FUSED_WINDOW": "2",
         "EOV_FUSED_SCALE": "64", "EOV_FUSED_CROP": "56",
         "EOV_FUSED_DTYPE": "float32"}


def test_fused_eval_schema_and_parity_rail(monkeypatch, capsys):
    """One line with the reference's keys; the fused step (the backbone
    per episode member) is slower than the cached one; in f32 on the CPU
    the two sides agree on every step's accuracy exactly."""
    _env(monkeypatch, FUSED)
    (rec,) = _lines(fused_eval.main, capsys)
    assert rec["metric"] == "fused_vs_cached_eval_step"
    assert rec["unit"] == "x_slower_per_step"
    d = rec["detail"]
    for key in ("platform", "arch", "bank_cmk_hw", "episodes_per_step",
                "backbone_chunk", "fused_step_s", "fused_eps_per_s",
                "fused_step_s_band", "cached_step_s", "cached_eps_per_s",
                "cached_step_s_band", "extract_bank_s", "protocol_episodes",
                "protocol_fused_s", "protocol_cached_s_incl_extract",
                "protocol_speedup_cached", "acc_max_delta", "window",
                "iters", "params"):
        assert key in d, key
    assert rec["value"] > 1 and d["fused_step_s"] > d["cached_step_s"]
    assert d["acc_max_delta"] == 0.0
    assert len(d["acc_per_step_fused"]) == 2
    assert d["bank_cmk_hw"] == [6, 4, 2, 64, 80] and d["gpu"] is None
    assert d["protocol_cached_s_incl_extract"] > d["extract_bank_s"]


def test_fused_eval_chunk_fallback(monkeypatch, capsys):
    """A chunk that does not divide the step's clips becomes one chunk of
    all of them, as in the reference."""
    _env(monkeypatch, {**FUSED, "EOV_FUSED_CHUNK": "7",
                       "EOV_FUSED_WINDOW": "1"})
    (rec,) = _lines(fused_eval.main, capsys)
    assert rec["detail"]["backbone_chunk"] == 4 * 5 * 2
    assert rec["detail"]["acc_max_delta"] == 0.0


CLASSIFY = {"EOV_CLASSIFY_DEVICE": "cpu", "EOV_CLASSIFY_REPEATS": "2",
            "EOV_CLASSIFY_ARCH": "resnet18", "EOV_CLASSIFY_FRAMES": "8",
            "EOV_CLASSIFY_HW": "64x80", "EOV_CLASSIFY_CLASSES": "11",
            "EOV_CLASSIFY_QUERIES": "5", "EOV_CLASSIFY_BATCH": "3"}


@pytest.mark.parametrize("source,quant", [("jpeg", "0"), ("eovc_raw", "0"),
                                          ("eovc_raw", "int8")])
def test_classify_schema(monkeypatch, capsys, source, quant):
    """Both axes (batch-1 ms/query inside its band, batched queries/s),
    the matcher the small part; the frame source named."""
    if source == "jpeg":
        pytest.importorskip("PIL")
    _env(monkeypatch, {**CLASSIFY, "EOV_CLASSIFY_FRAMES_FROM": source,
                       "EOV_CLASSIFY_QUANT": quant})
    (rec,) = _lines(classify.main, capsys)
    assert rec["metric"] == "classify_query_latency"
    assert rec["unit"] == "ms/query"
    d = rec["detail"]
    assert d["ms_min"] <= rec["value"] <= d["ms_max"]
    assert d["queries_per_s_batched"] > 0
    assert d["match_ms_median"] < rec["value"]
    assert d["support_classes"] == 11 and d["feature_dim"] == 512
    assert d["frames_from"] == source
    assert d["reader"].startswith("FrameFolderDataset" if source == "jpeg"
                                  else "EovcVideoDataset")
    assert d["quant"] == ("int8" if quant == "int8" else None)


def test_episode_schema(monkeypatch, capsys):
    """Config 1: one line, median inside its own band, 10 clips an
    episode (clips from a RAW shard; classify covers the JPEG source)."""
    source = "eovc_raw"
    _env(monkeypatch, {"EOV_EPISODE_DEVICE": "cpu",
                       "EOV_EPISODE_FRAMES_FROM": source,
                       "EOV_EPISODE_REPEATS": "2",
                       "EOV_EPISODE_ARCH": "resnet18",
                       "EOV_EPISODE_FRAMES": "8", "EOV_EPISODE_HW": "64x80"})
    (rec,) = _lines(episode.main, capsys)
    assert rec["metric"] == "oneshot_episode_latency"
    assert rec["unit"] == "ms/episode"
    d = rec["detail"]
    assert d["ms_min"] <= rec["value"] <= d["ms_max"]
    assert d["clips_per_episode"] == 10 and d["arch"] == "resnet18"
    assert d["frames_decoded"] == 80 and d["frames_from"] == source
    assert 0.0 <= d["accuracy_mean"] <= 1.0


def test_decode_one_line_per_path(monkeypatch, capsys):
    """A line per path, each with its reader; every path that runs here
    reads > 0 clips/s, and a path that cannot run gives null and why."""
    _env(monkeypatch, {"EOV_DECODE_CLIPS": "4", "EOV_DECODE_K": "3"})
    recs = _lines(decode.main, capsys)
    paths = [r["detail"]["path"] for r in recs]
    assert paths == ["eovc_raw", "python_raw", "eovc_jpeg", "python_jpeg",
                     "eovc_jpeg_hires_full", "eovc_jpeg_hires_s2",
                     "videodir_pooled", "videodir_per_record"]
    for r in recs:
        assert r["metric"] == "host_clip_decode_throughput"
        if r["value"] is None:
            assert r["detail"]["reason"] and r["detail"]["reader"] is None
        else:
            assert r["value"] > 0 and r["detail"]["reader"]
    by_path = {r["detail"]["path"]: r for r in recs}
    assert by_path["python_raw"]["value"] > 0
    assert by_path["python_raw"]["detail"]["reader"] == "python"


def test_decode_path_without_its_reader_is_null(monkeypatch, tmp_path,
                                                capsys):
    """Without cv2 the video paths print null and the reason."""
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no module named cv2")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    line = decode._Lines()
    decode._videodir_paths(line, str(tmp_path), 2, 2, {"k": 2})
    recs = _lines(lambda: None, capsys)
    assert line.printed == ["videodir_pooled", "videodir_per_record"]
    for r in recs:
        assert r["value"] is None and "cv2" in r["detail"]["reason"]


@pytest.mark.parametrize("mod,env", [
    (classify, {"EOV_CLASSIFY_FRAMES_FROM": "png"}),
    (episode, {"EOV_EPISODE_FRAMES_FROM": "png"}),
    (classify, {"EOV_CLASSIFY_QUANT": "int4"})])
def test_benches_refuse_unknown_knobs(monkeypatch, mod, env):
    _env(monkeypatch, {"EOV_CLASSIFY_DEVICE": "cpu",
                       "EOV_EPISODE_DEVICE": "cpu", **env})
    with pytest.raises(SystemExit):
        mod.main()


@pytest.mark.parametrize("mod,var", [(classify, "EOV_CLASSIFY_DEVICE"),
                                     (episode, "EOV_EPISODE_DEVICE"),
                                     (fused_eval, "EOV_BENCH_DEVICE")])
def test_benches_default_to_cuda(monkeypatch, mod, var):
    """The device defaults to cuda; without a GPU that raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()
