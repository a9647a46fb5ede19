"""Headline bench of the PyTorch + CUDA port: ResNet-50 clip-feature
throughput on one GPU (clips/s). Prints ONE JSON line.

The port's counterpart of ``bench.py``; the bench itself is
``eov_tpu_torch/bench/features.py`` (its docstring lists the
``EOV_BENCH_*`` knobs). Runs on the GPU (``EOV_BENCH_DEVICE=cpu`` for a
CPU run at small settings); without a GPU it exits with an error.

    python3 bench_torch.py
    EOV_BENCH_FRAME_HW=256x320 EOV_BENCH_SCALE=256 python3 bench_torch.py
"""

from __future__ import annotations


def main() -> None:
    from eov_tpu_torch.bench import features

    features.main()


if __name__ == "__main__":
    main()
