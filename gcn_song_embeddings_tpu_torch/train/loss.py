"""Loss functions and training diagnostics (the JAX package's
``train/loss.py``: the same clamps and divisors)."""

from __future__ import annotations

import torch


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows divided by their L2 norm, clamped below at ``eps``."""
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def max_margin_loss(h_q: torch.Tensor, h_pos: torch.Tensor,
                    h_neg: torch.Tensor, margin: float) -> torch.Tensor:
    """Max-margin triplet loss: rows L2-normalized, then
    mean(relu(q.neg - q.pos + margin))."""
    q = _l2_normalize(h_q)
    q_dot_pos = (q * _l2_normalize(h_pos)).sum(dim=1)
    q_dot_neg = (q * _l2_normalize(h_neg)).sum(dim=1)
    return torch.clamp(q_dot_neg - q_dot_pos + margin, min=0.0).mean()


def cosine_triplet_loss(a: torch.Tensor, p: torch.Tensor, n: torch.Tensor,
                        margin: float = 1e-4) -> torch.Tensor:
    """Diagnostic triplet loss with cosine dissimilarity d = 1 - cos:
    mean(relu(d(a, p) - d(a, n) + margin)); callers feed L2-normalized
    raw feature rows."""
    def cos(x, y):
        nx = torch.linalg.vector_norm(x, dim=1)
        ny = torch.linalg.vector_norm(y, dim=1)
        return (x * y).sum(dim=1) / torch.clamp(nx * ny, min=1e-8)

    d_ap = 1.0 - cos(a, p)
    d_an = 1.0 - cos(a, n)
    return torch.clamp(d_ap - d_an + margin, min=0.0).mean()


def batch_variance(h: torch.Tensor) -> torch.Tensor:
    """Collapse monitor: the summed squared deviation from the per-dim
    batch mean, / (B - 1)."""
    return ((h - h.mean(dim=0)) ** 2).sum() / (h.shape[0] - 1)
