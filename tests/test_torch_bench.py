"""The port's benches and its FLOPs model on the CPU.

Each bench's ``main()`` prints exactly one JSON line with the reference
benches' schema (as ``tests/test_bench.py`` holds the reference's), its
value inside its own min/max band, and no MFU off the card. The FLOPs
model gives the reference's integers. The benches' times are CPU times
here and say nothing of the card. About 20 s.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from eov_tpu.utils.flops import resnet_forward_flops as j_flops

from eov_tpu_torch.bench import common
from eov_tpu_torch.utils.flops import resnet_forward_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one_line(main, capsys) -> dict:
    main()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, f"a bench prints exactly one line, got {out}"
    return json.loads(out[0])


def _cpu_only(d: dict) -> None:
    assert d["device"] == "cpu" and d["gpu"] is None
    for k in ("mfu", "peak_tflops"):
        if k in d:
            assert d[k] is None


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50",
                                  "resnet101", "resnet152"])
@pytest.mark.parametrize("hw", [(224, 224), (97, 131)])
def test_flops_equal_reference(arch, hw):
    assert resnet_forward_flops(arch, hw) == j_flops(arch, hw)
    assert (resnet_forward_flops(arch, hw, num_classes=101, width=32)
            == j_flops(arch, hw, num_classes=101, width=32))


def test_flops_resnet50_headline():
    # 8.17 GFLOP an image (4.09 G multiply-accumulates), convs only
    assert resnet_forward_flops("resnet50") == 8_174_272_512


def test_feature_bench_schema(monkeypatch, capsys):
    for k, v in {"EOV_BENCH_DEVICE": "cpu", "EOV_BENCH_ARCH": "resnet18",
                 "EOV_BENCH_BATCH": "1", "EOV_BENCH_ITERS": "1",
                 "EOV_BENCH_WINDOW": "1", "EOV_BENCH_REPEATS": "2"}.items():
        monkeypatch.setenv(k, v)
    sys.path.insert(0, ROOT)
    import bench_torch

    rec = _one_line(bench_torch.main, capsys)
    assert rec["metric"] == "resnet18_clip_features_throughput"
    assert rec["unit"] == "clips/sec/gpu"
    assert rec["value"] > 0
    assert abs(rec["vs_baseline"] - rec["value"] / 1000.0) < 1e-4
    d = rec["detail"]
    _cpu_only(d)
    assert d["clips_per_sec_min"] <= rec["value"] <= d["clips_per_sec_max"]
    assert d["repeats"] == 2 and d["median_step_s"] > 0
    assert d["variant"] == "crop_kernel+fold_bn"  # 224x224: normalize only
    assert d["flops_source"] == "analytic_backbone"
    assert d["step_tflops"] == round(8 * resnet_forward_flops(
        "resnet18") / 1e12, 3)
    for k in ("arch", "batch_clips", "num_segments", "frame_hw",
              "effective_tflops_per_s", "quant", "window", "iters",
              "spread_pct", "peak_source"):
        assert k in d


@pytest.mark.parametrize("env, said", [
    ({"EOV_BENCH_QUANT": "int4"}, "EOV_BENCH_QUANT"),
    ({"EOV_BENCH_PALLAS_POOL": "2"}, "EOV_BENCH_PALLAS_POOL"),
    ({"EOV_BENCH_FUSED_STAGES": "x"}, "EOV_BENCH_FUSED_STAGES"),
    ({"EOV_BENCH_QUANT": "int8", "EOV_BENCH_S2D": "1"}, "EOV_BENCH_S2D"),
    ({"EOV_BENCH_QUANT": "int8", "EOV_BENCH_FUSED_STAGES": "1,2"},
     "composes only"),
    ({"EOV_BENCH_PALLAS_POOL": "fused", "EOV_BENCH_FUSED_STAGES": "none"},
     "requires stage 1 fused"),
])
def test_feature_bench_refusals(monkeypatch, env, said):
    from eov_tpu_torch.bench import features

    monkeypatch.setenv("EOV_BENCH_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=said):
        features.main()


def test_train_bench_schema(monkeypatch, capsys):
    from eov_tpu_torch.bench import train

    monkeypatch.setenv("EOV_BENCH_DEVICE", "cpu")
    rec = _one_line(train.main, capsys)
    assert rec["metric"] == "tsn_finetune_step_throughput"
    assert rec["value"] > 0
    d = rec["detail"]
    _cpu_only(d)
    assert d["clips_per_sec_min"] <= rec["value"] <= d["clips_per_sec_max"]
    # 3x the forward of 2 clips x 3 segments at the 32x32 crop.
    assert d["step_tflops_model"] == round(
        3 * 6 * resnet_forward_flops("resnet50", (32, 32)) / 1e12, 3)
    assert d["model_tflops_per_s"] >= 0


@pytest.mark.parametrize("matcher", ["auto", "xla"])
def test_eval_bench_schema(monkeypatch, capsys, matcher):
    from eov_tpu_torch.bench import eval as bench_eval

    monkeypatch.setenv("EOV_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("EOV_EVAL_MATCHER", matcher)
    monkeypatch.setenv("EOV_EVAL_ITERS", "1")
    monkeypatch.setenv("EOV_EVAL_WINDOW", "1")
    rec = _one_line(bench_eval.main, capsys)
    assert rec["metric"] == "oneshot_eval_throughput"
    assert rec["value"] > 0
    d = rec["detail"]
    _cpu_only(d)
    assert d["matcher"] == matcher and d["table_cmd"] == [24, 100, 2048]
    assert d["eps_per_sec_min"] <= rec["value"] <= d["eps_per_sec_max"]
    assert d["full_600_episode_eval_s"] > 0
    assert 0.0 <= d["mean_accuracy"] <= 1.0


def test_eval_bench_refuses_pallas_on_cpu(monkeypatch):
    from eov_tpu_torch.bench import eval as bench_eval

    monkeypatch.setenv("EOV_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("EOV_EVAL_MATCHER", "pallas")
    with pytest.raises(SystemExit, match="CUDA device only"):
        bench_eval.main()


def test_e2e_bench_schema(monkeypatch, capsys, tmp_path):
    from eov_tpu_torch.bench import e2e

    for k, v in {"EOV_BENCH_DEVICE": "cpu", "EOV_E2E_CLIPS": "5",
                 "EOV_E2E_BATCH": "2", "EOV_E2E_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)
    rec = _one_line(e2e.main, capsys)
    assert rec["metric"] == "e2e_sustained_extraction_throughput"
    assert rec["value"] > 0
    d = rec["detail"]
    assert d["device"] == "cpu" and d["gpu"] is None
    assert d["clips"] == d["extracted"] == 5  # the tail batch was padded
    assert d["reader"] in ("native", "python")
    assert d["device_idle_share_est"] is None  # no device off the card
    assert d["host_decode_only_clips_per_s"] > 0
    assert os.listdir(tmp_path) == []  # the work directory is removed


def test_mfu_peak_table(monkeypatch):
    """The MFU divides by the card's dense peak from the table; an unknown
    card or the CPU gets none, with the reason."""
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    f = common.mfu_fields(989.4e12 / 4, dev)
    assert f["mfu"] == 0.25 and f["peak_tflops"] == 989.4
    f8 = common.mfu_fields(1978.9e12 / 2, dev, int8=True)
    assert f8["mfu"] == 0.5 and f8["peak_source"].startswith("int8")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 PCIe")
    assert common.mfu_fields(756.5e12, dev)["mfu"] == 1.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Some Other GPU")
    f = common.mfu_fields(1e12, dev)
    assert f["mfu"] is None and "Some Other GPU" in f["peak_source"]
    assert common.mfu_fields(1e12, torch.device("cpu"))["mfu"] is None


def test_bench_refuses_without_gpu():
    """bench_torch.py asks for the GPU by default: without one it exits
    non-zero and prints no result line; it never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    env = {k: v for k, v in os.environ.items() if k != "EOV_BENCH_DEVICE"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr


def test_cli_bench_runs_the_feature_bench(monkeypatch, capsys):
    """``cli bench --platform cpu`` is the feature bench on the CPU."""
    from eov_tpu_torch import cli

    for k, v in {"EOV_BENCH_DEVICE": "cuda", "EOV_BENCH_ARCH": "resnet18",
                 "EOV_BENCH_BATCH": "1", "EOV_BENCH_ITERS": "1",
                 "EOV_BENCH_WINDOW": "1"}.items():
        monkeypatch.setenv(k, v)  # restored after the test
    assert cli.main(["bench", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert rec["metric"] == "resnet18_clip_features_throughput"
    assert rec["detail"]["device"] == "cpu"
