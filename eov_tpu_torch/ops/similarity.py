"""Batched one-shot matcher: similarity, per-class fusion, argmax.

Counterpart of ``eov_tpu/ops/similarity.py`` (the plain functions:
``l2_normalize``, ``pairwise_scores``, ``fused_class_scores``, ``predict``)
and of ``eov_tpu/ops/pallas_similarity.py:episode_class_scores`` (kernel 3
of the port, ``csrc/episode_scores.cu``). Shapes, class-major support:

    query   [E, Q, D]      support [E, N, M, D]      mask [E, N, M] (1 valid)

Every product runs in full f32 (TF32 off): near-tie argmaxes flip under
reduced-precision inputs, which is why the reference pins these matmuls to
``Precision.HIGHEST``.
"""

from __future__ import annotations

import ctypes

import torch

from eov_tpu_torch.ops import _cuda
from eov_tpu_torch.utils import trace

__all__ = ["l2_normalize", "pairwise_scores", "fused_class_scores", "predict",
           "episode_class_scores", "episode_scores_plain",
           "episode_scores_cuda", "MAX_ROWS"]

_NEG = -1e30
MAX_ROWS = 6144  # query + support rows of one episode the wrapper takes
                 # (classify chunks its store and queries to fit)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along dim (F.normalize semantics)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(n, eps)


def pairwise_scores(query: torch.Tensor, support: torch.Tensor,
                    metric: str = "cosine") -> torch.Tensor:
    """Scores [..., Q, S]: cosine, or negative squared euclidean distance
    through the matmul expansion -|q|^2 - |s|^2 + 2 q.s."""
    if metric == "cosine":
        return torch.einsum("...qd,...sd->...qs", l2_normalize(query),
                            l2_normalize(support))
    if metric == "euclidean":
        dots = torch.einsum("...qd,...sd->...qs", query, support)
        q2 = torch.sum(query * query, dim=-1)[..., :, None]
        s2 = torch.sum(support * support, dim=-1)[..., None, :]
        return 2.0 * dots - q2 - s2
    raise ValueError(f"unknown metric: {metric}")


def _prototypes(support, mask):
    w = mask[..., None]
    return torch.sum(support * w, dim=-2) / torch.clamp_min(
        torch.sum(w, dim=-2), 1.0)


def fused_class_scores(query, support, mask=None, *, metric="cosine",
                       fusion="max") -> torch.Tensor:
    """Per-class scores [..., Q, N]: 'max' = best member similarity (union
    support), 'mean' = similarity to the masked mean member (prototype,
    taken before normalization)."""
    n, m = support.shape[-3], support.shape[-2]
    if fusion == "mean":
        proto = (support.mean(dim=-2) if mask is None
                 else _prototypes(support, mask))
        return pairwise_scores(query, proto, metric)
    if fusion == "max":
        flat = support.reshape(*support.shape[:-3], n * m, support.shape[-1])
        s = pairwise_scores(query, flat, metric)
        s = s.reshape(*s.shape[:-1], n, m)
        if mask is not None:
            s = torch.where(mask[..., None, :, :] > 0, s,
                            torch.full_like(s, _NEG))
        return s.amax(dim=-1)
    raise ValueError(f"unknown fusion: {fusion}")


def predict(query, support, mask=None, *, metric="cosine", fusion="max"):
    """Predicted class ids [..., Q] (ties to the lower class, as argmax)."""
    return fused_class_scores(query, support, mask, metric=metric,
                              fusion=fusion).argmax(dim=-1)


def _check(query, support, mask, metric):
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"unknown metric: {metric}")
    if query.dim() != 3 or support.dim() != 4 or mask.dim() != 3:
        raise ValueError("expected query [E,Q,D], support [E,N,M,D], "
                         "mask [E,N,M]")
    e, _, d = query.shape
    if support.shape[0] != e or support.shape[3] != d or \
            tuple(mask.shape) != tuple(support.shape[:3]):
        raise ValueError(f"shape mismatch: query {tuple(query.shape)}, "
                         f"support {tuple(support.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if support.shape[2] < 1:
        raise ValueError("every class needs at least one member slot")


def episode_scores_plain(query, support, mask, *,
                         metric="cosine") -> torch.Tensor:
    """Plain PyTorch version of the kernel: rsqrt-normalized rows (cosine),
    dots in f32, -1e30 mask bias, max over members."""
    _check(query, support, mask, metric)
    q = query.float()
    s = support.float()
    if metric == "cosine":
        q = q * torch.rsqrt(torch.clamp_min((q * q).sum(-1, keepdim=True),
                                            1e-24))
        s = s * torch.rsqrt(torch.clamp_min((s * s).sum(-1, keepdim=True),
                                            1e-24))
    dots = torch.einsum("eqd,enmd->eqnm", q, s)
    if metric == "cosine":
        sims = dots
    else:
        sims = (2.0 * dots - (q * q).sum(-1)[:, :, None, None]
                - (s * s).sum(-1)[:, None, :, :])
    bias = torch.where(mask > 0, 0.0, _NEG).to(sims.dtype)
    return (sims + bias[:, None]).amax(dim=-1)


def _lib():
    lib = _cuda.load("episode_scores")
    fn = lib.episode_scores_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def episode_scores_cuda(query, support, mask, *,
                        metric="cosine") -> torch.Tensor:
    """The CUDA kernel on contiguous f32 CUDA tensors."""
    _check(query, support, mask, metric)
    for name, t in (("query", query), ("support", support), ("mask", mask)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != query.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{query.device}")
    e, q, d = query.shape
    n, m = support.shape[1], support.shape[2]
    if q + n * m > MAX_ROWS:
        raise ValueError(f"{q + n * m} rows per episode > {MAX_ROWS}")
    out = torch.empty(e, q, n, dtype=torch.float32, device=query.device)
    vec = int(d % 4 == 0 and query.data_ptr() % 16 == 0
              and support.data_ptr() % 16 == 0)
    code = _lib().episode_scores_launch(
        _cuda.ptr(query), _cuda.ptr(support), _cuda.ptr(mask), _cuda.ptr(out),
        e, q, n, m, d, int(metric == "cosine"), vec,
        _cuda.stream_ptr(query.device))
    _cuda.check(code, "episode_scores")
    trace.count("launch.episode_class_scores")
    return out


def episode_class_scores(query, support, mask, *, metric="cosine",
                         fusion="max", plain: bool = False) -> torch.Tensor:
    """Fused per-class scores [E, Q, N]: the kernel on CUDA tensors, the
    plain version on CPU tensors, and with ``plain=True`` the plain version
    on either (the eval's ``matcher='xla'``).

    fusion='mean' averages each class's valid members on the caller side
    and scores the prototypes with M=1 (a class with no valid member is
    masked), as the reference kernel's wrapper does.
    """
    if fusion == "mean":
        proto = _prototypes(support, mask)[:, :, None]
        mask = (mask.sum(dim=2, keepdim=True) > 0).to(mask.dtype)
        support = proto
    elif fusion != "max":
        raise ValueError(f"unknown fusion: {fusion}")
    kind = query.device.type
    if plain and kind in ("cuda", "cpu"):
        return episode_scores_plain(query, support, mask, metric=metric)
    if kind == "cuda":
        return episode_scores_cuda(query.float().contiguous(),
                                   support.float().contiguous(),
                                   mask.float().contiguous(), metric=metric)
    if kind == "cpu":
        return episode_scores_plain(query, support, mask, metric=metric)
    raise ValueError(f"episode_class_scores: unsupported device "
                     f"{query.device}")
