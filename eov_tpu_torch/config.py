"""Frozen config presets — the port's own copy of the reference's table.

Counterpart of ``eov_tpu/config.py``: the same preset names and protocol
settings, built from the port's ``EvalConfig`` and ``ExtractConfig``,
and the frame-axis size ``n_frame`` of ``extract --multichip``'s
('data', 'frame') mesh. The data axis is every other rank of the
torchrun world: the reference's ``n_data`` field is read nowhere there,
so the port has none.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from eov_tpu_torch.eval import EvalConfig
from eov_tpu_torch.extract import ExtractConfig

__all__ = ["Preset", "PRESETS", "get_preset", "resolved_dict"]


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    eval: EvalConfig = EvalConfig()
    extract: ExtractConfig = ExtractConfig()
    n_frame: int = 1            # mesh frame-axis size (data = the rest)


PRESETS: dict[str, Preset] = {
    p.name: p
    for p in [
        Preset(
            name="episode_cpu",
            description="Config 1: single 5-way 1-shot episode, raw clips, "
                        "batch 1",
            eval=EvalConfig(n_way=5, k_shot=1, n_query=1, n_episodes=1,
                            episodes_per_step=1),
            extract=ExtractConfig(batch_clips=1, compute_dtype="float32",
                                  deterministic=True),
        ),
        Preset(
            name="ucf101_600",
            description="Config 2: UCF101 one-shot eval, K=8, 600 episodes, "
                        "mean±95% CI",
            eval=EvalConfig(n_way=5, k_shot=1, n_query=1, n_episodes=600,
                            episodes_per_step=64),
            extract=ExtractConfig(num_segments=8),
        ),
        Preset(
            name="kinetics_embodied",
            description="Config 3: Kinetics-100 meta-test + UnrealAction "
                        "virtual supports",
            eval=EvalConfig(n_way=5, k_shot=1, n_query=1, n_episodes=600,
                            episodes_per_step=64, embodied=True,
                            fusion="max"),
            extract=ExtractConfig(num_segments=8),
        ),
        Preset(
            name="tpu_batched",
            description="Config 4: fused batched eval, 64 episodes/step "
                        "(the reference's accelerator preset)",
            eval=EvalConfig(n_way=5, k_shot=1, n_query=1, n_episodes=600,
                            episodes_per_step=64),
            extract=ExtractConfig(num_segments=8, batch_clips=32),
        ),
        Preset(
            name="pod_extract",
            description="Config 5: pod-scale extraction, clips sharded "
                        "over every rank of the torchrun world",
            eval=EvalConfig(),
            extract=ExtractConfig(num_segments=8, batch_clips=128,
                                  flush_every=1024),
        ),
        Preset(
            name="kinetics_5shot",
            description="CMN-protocol 5-way 5-shot eval",
            eval=EvalConfig(n_way=5, k_shot=5, n_query=1, n_episodes=600,
                            episodes_per_step=64, fusion="mean"),
            extract=ExtractConfig(num_segments=8),
        ),
        Preset(
            name="kinetics_10k",
            description="CMN-lineage long protocol: 10,000 episodes",
            eval=EvalConfig(n_way=5, k_shot=1, n_query=1, n_episodes=10_000,
                            episodes_per_step=64),
            extract=ExtractConfig(num_segments=8),
        ),
        Preset(
            name="synthetic_smoke",
            description="Dev: tiny synthetic end-to-end on CPU",
            eval=EvalConfig(n_way=3, k_shot=1, n_query=2, n_episodes=30,
                            episodes_per_step=10),
            extract=ExtractConfig(num_segments=4, batch_clips=4,
                                  compute_dtype="float32",
                                  deterministic=True),
        ),
    ]
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset '{name}'; have {sorted(PRESETS)}")
    return PRESETS[name]


def resolved_dict(obj: Any) -> dict:
    """Dataclass tree -> JSON-able dict (for metrics.jsonl logging)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: resolved_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [resolved_dict(x) for x in obj]
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        return str(obj)
