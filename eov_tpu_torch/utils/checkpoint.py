"""Train-run checkpoints (counterpart of ``eov_tpu/utils/checkpoint.py``).

The reference saves its train state with orbax, which the port does not
have. The port's format, one directory per epoch under the run directory:

    <run>/step_{epoch}/state.pt   torch.save of a dict:
        "format"     1
        "model"      the ResNet state_dict: torchvision names, fc head and
                     BN running statistics included, float32 CPU tensors
        "optimizer"  torch.optim.SGD.state_dict() (momentum buffers)
        "step"       completed optimizer updates (int)
    <run>/best.json  {"epoch", "val_acc", "ci95", "dir": "step_{epoch}"}:
                     the best meta-val epoch (written by ``cli train`` when
                     it validates; the same file as the reference's)

``state.pt`` is written to a temporary name and renamed, so a crash never
leaves a torn checkpoint; ``latest_step_dir`` picks the newest epoch for
resume.
"""

from __future__ import annotations

import os

import torch

__all__ = ["FORMAT", "STATE_FILE", "save_state", "read_state", "load_state",
           "latest_step_dir"]

FORMAT = 1
STATE_FILE = "state.pt"


def save_state(path: str, state) -> None:
    """Write ``state`` (``train.TrainState``) to ``path/state.pt``."""
    os.makedirs(path, exist_ok=True)
    doc = {
        "format": FORMAT,
        "model": {k: v.detach().cpu().contiguous()
                  for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(doc, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def read_state(path: str) -> dict:
    """The checkpoint dict of ``path`` (a ``step_N`` dir or its file)."""
    f = path if path.endswith(".pt") else os.path.join(path, STATE_FILE)
    if not os.path.exists(f):
        raise FileNotFoundError(f"no train checkpoint at {f}")
    doc = torch.load(f, map_location="cpu", weights_only=True)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{f}: checkpoint format {doc.get('format')!r}, "
                         f"expected {FORMAT}")
    return doc


def load_state(path: str, state):
    """Restore model, optimizer and step from ``path`` into ``state`` (a
    ``train.TrainState`` built for the same config) and return it."""
    doc = read_state(path)
    state.model.load_state_dict(doc["model"])
    state.optimizer.load_state_dict(doc["optimizer"])
    state.step = int(doc["step"])
    return state


def latest_step_dir(root: str) -> str | None:
    """Newest ``step_N`` subdirectory under root (train-loop resume)."""
    if not os.path.isdir(root):
        return None
    steps = [int(d[5:]) for d in os.listdir(root)
             if d.startswith("step_") and d[5:].isdigit()]
    return os.path.join(root, f"step_{max(steps)}") if steps else None
