"""Embodied support augmentation: the virtual (UnrealAction) feature bank.

Counterpart of ``eov_tpu/embodied.py``. Clips of a virtual agent performing
the same action classes join each episode's support set, so a one-shot
class is its real clip plus its virtual clips. This module aligns a virtual
store's classes with the real split's by class NAME (ids differ between
datasets) and builds the padded ``[C, V, D]`` bank that ``eval.eval_step``
appends to the support members, and ``union_support``, the same rule over a
whole split, which ``classify`` scores against.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from eov_tpu_torch.eval import FeatureTable

__all__ = ["align_virtual_bank", "normalize_class_name", "union_support"]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def union_support(table: FeatureTable, class_names: Sequence[str],
                  virtual_class_names: Sequence[str] | None = None,
                  virtual_table: FeatureTable | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Class-major support of a whole split: features [C, M(+V), D] and mask
    [C, M(+V)] (float32, on the table's device). With a virtual table, its
    bank is aligned to the real class axis and concatenated along the
    member axis. Raises on a feature-dimension mismatch between the banks.
    """
    dev = table.features.device
    feats = _np(table.features).astype(np.float32)
    counts = _np(table.counts)
    mask = (np.arange(feats.shape[1])[None, :] < counts[:, None]).astype(
        np.float32)
    if virtual_table is not None:
        bank = align_virtual_bank(class_names, list(virtual_class_names or []),
                                  virtual_table)
        vf = _np(bank.features).astype(np.float32)
        vc = _np(bank.counts)
        if vf.shape[-1] != feats.shape[-1]:
            raise ValueError(
                f"real ({feats.shape[-1]}-d) and virtual ({vf.shape[-1]}-d) "
                "features come from different backbones; re-extract one side")
        vmask = (np.arange(vf.shape[1])[None, :] < vc[:, None]).astype(
            np.float32)
        feats = np.concatenate([feats, vf], axis=1)
        mask = np.concatenate([mask, vmask], axis=1)
    return torch.from_numpy(feats).to(dev), torch.from_numpy(mask).to(dev)


def normalize_class_name(name: str) -> str:
    """Canonical form for cross-dataset alignment ('HighJump', 'high jump'
    and 'high_jump' agree): lower case, separators stripped."""
    return "".join(ch for ch in name.lower() if ch.isalnum())


def align_virtual_bank(real_class_names: Sequence[str],
                       virtual_class_names: Sequence[str],
                       virtual_table: FeatureTable) -> FeatureTable:
    """Reindex a virtual table onto the real split's class axis: features
    [C_real, V, D], counts [C_real] on the virtual table's device. A real
    class without a virtual counterpart gets count 0 (plain one-shot for
    that way); a bank that would make every class plain is refused."""
    if not real_class_names:
        raise ValueError(
            "real store has no class names — cannot align a virtual bank "
            "(re-extract with a dataset that carries class names)")
    by_name = {normalize_class_name(n): i
               for i, n in enumerate(virtual_class_names)}
    vf = _np(virtual_table.features)
    vc = _np(virtual_table.counts)
    c_real = len(real_class_names)
    out_f = np.zeros((c_real, vf.shape[1], vf.shape[2]), vf.dtype)
    out_c = np.zeros((c_real,), np.int64)
    missing = []
    for i, name in enumerate(real_class_names):
        j = by_name.get(normalize_class_name(name))
        if j is None:
            missing.append(name)
            continue
        out_f[i] = vf[j]
        out_c[i] = vc[j]
    if len(missing) == c_real:
        raise ValueError(
            "no virtual class aligns with ANY real class (real e.g. "
            f"{list(real_class_names)[:3]}, virtual e.g. "
            f"{list(virtual_class_names)[:3]}) — embodied eval would "
            "silently equal plain eval; check both stores carry real class "
            "names")
    if not np.any(out_c):
        raise ValueError(
            "virtual bank aligns by name but contributes 0 clips for every "
            "real class — embodied eval would silently equal plain eval; the "
            "virtual store appears empty for these classes")
    dev = virtual_table.features.device
    return FeatureTable(torch.from_numpy(out_f).to(dev),
                        torch.from_numpy(out_c).to(dev))
