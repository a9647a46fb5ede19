"""``--debug-nans``: finite checks on the outputs of a command.

Counterpart of the reference's ``jax_debug_nans`` switch
(``eov_tpu/cli.py --debug-nans``). Inside ``debug_nans()`` every
``check_finite`` call tests its tensor with ``torch.isfinite`` and raises
``FloatingPointError`` naming it; outside, a call returns at once and costs
no device synchronization. The call sites are the outputs a command
produces: clip features (``extract.make_feature_fn``), episode scores
(``eval.eval_step``, classify), and the train step's loss and gradients.
The CLI's ``train --debug-nans`` also runs under
``torch.autograd.set_detect_anomaly(True)``, which names the backward
operation that made a NaN.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["debug_nans", "enabled", "check_finite"]

_ON = contextvars.ContextVar("eov_debug_nans", default=False)


@contextlib.contextmanager
def debug_nans(on: bool = True):
    """Turn the checks on (or off) for the calls inside the block."""
    token = _ON.set(on)
    try:
        yield
    finally:
        _ON.reset(token)


def enabled() -> bool:
    return _ON.get()


def check_finite(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` itself; raises inside ``debug_nans()`` if it holds a NaN or
    an infinity."""
    if _ON.get() and not bool(torch.isfinite(t).all()):
        bad = int((~torch.isfinite(t)).sum())
        raise FloatingPointError(
            f"--debug-nans: {name} holds {bad} non-finite value(s) of "
            f"{t.numel()} (shape {tuple(t.shape)}, {t.dtype}, {t.device})")
    return t
