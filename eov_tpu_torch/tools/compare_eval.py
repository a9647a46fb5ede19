"""Paired comparison of two one-shot eval runs, episode by episode.

Counterpart of ``eov_tpu/tools/compare_eval.py``, with the same
``compare()``, output and exit codes. Episode g of a protocol draws from
``fold_in(seed, g)`` (``episodes.py``), so two runs over the same store
with the same seed and sampling protocol score the IDENTICAL episodes, and
their difference admits a paired analysis: mean difference ± 1.96·σ(diff)/√E
and win/loss/tie counts.

Usage:
    python -m eov_tpu_torch.cli eval --store S --per-episode-out plain.json
    python -m eov_tpu_torch.cli eval --store S --embodied --virtual-store V \\
        --per-episode-out emb.json
    python -m eov_tpu_torch.tools.compare_eval emb.json plain.json

Either package's ``--per-episode-out`` file is accepted, in any pairing.
Fields that must MATCH (episode identity): seed, n_way, k_shot, n_query,
n_episodes, and the per-class clip counts of the real table. Fields that
may differ (they change the scoring, not the sampling): embodied, fusion,
metric, matcher. A mismatch exits with code 2.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["compare", "main"]

_IDENTITY_FIELDS = ("seed", "n_way", "k_shot", "n_query", "n_episodes")
_VARIANT_FIELDS = ("embodied", "fusion", "metric", "matcher")


def compare(a: dict, b: dict) -> dict:
    """Paired stats of two --per-episode-out documents (a minus b)."""
    for f in _IDENTITY_FIELDS:
        va, vb = a["config"].get(f), b["config"].get(f)
        if va != vb:
            raise ValueError(
                f"runs sample different episodes: {f}={va!r} vs {vb!r} "
                "(identity fields must match for a paired comparison)")
    if a["counts"] != b["counts"]:
        raise ValueError(
            "runs sample different episodes: per-class clip counts differ "
            "(same store/split required)")
    pa = np.asarray(a["per_episode"], np.float64)
    pb = np.asarray(b["per_episode"], np.float64)
    if pa.shape != pb.shape:
        raise ValueError(f"episode count mismatch: {pa.shape} vs {pb.shape}")
    d = pa - pb
    e = len(d)
    ci = float(1.96 * d.std(ddof=1) / np.sqrt(e)) if e > 1 else float("nan")
    return {
        "n_episodes": e,
        "mean_a": float(pa.mean()),
        "mean_b": float(pb.mean()),
        "mean_diff": float(d.mean()),
        "ci95_paired": ci,
        "significant": bool(e > 1 and abs(d.mean()) > ci),
        "wins": int((d > 0).sum()),
        "losses": int((d < 0).sum()),
        "ties": int((d == 0).sum()),
        "variant_a": {f: a["config"].get(f) for f in _VARIANT_FIELDS},
        "variant_b": {f: b["config"].get(f) for f in _VARIANT_FIELDS},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "compare_eval",
        description="paired episode-level comparison of two "
                    "`eval --per-episode-out` dumps (A minus B)")
    ap.add_argument("run_a")
    ap.add_argument("run_b")
    args = ap.parse_args(argv)
    with open(args.run_a) as f:
        a = json.load(f)
    with open(args.run_b) as f:
        b = json.load(f)
    try:
        out = compare(a, b)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out))
    print(
        f"A {out['mean_a'] * 100:.2f}% vs B {out['mean_b'] * 100:.2f}%: "
        f"diff {out['mean_diff'] * 100:+.2f}% "
        f"+/- {out['ci95_paired'] * 100:.2f}% (paired, "
        f"{out['wins']}W/{out['losses']}L/{out['ties']}T over "
        f"{out['n_episodes']} shared episodes)",
        file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
