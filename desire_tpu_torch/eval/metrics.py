"""Forecast metrics (port of ``desire_tpu/eval/metrics.py``; only the top-1
pick the serving path needs so far)."""

from __future__ import annotations

import torch


def best_of_k_by_score(pred, scores, blend=0.0):
    """Each agent's top-scored hypothesis. pred (B, A, K, T, 2), scores
    (B, A, K) -> (B, A, T, 2).

    blend > 0 adds the z-normalized lane typicality (negative endpoint
    distance to the K-lane mean endpoint) to the z-normalized score before
    the argmax. Standard deviations are population ones, as in the JAX
    package."""
    if blend:
        ends = pred[..., -1, :]
        typ = -torch.linalg.norm(ends - ends.mean(dim=2, keepdim=True),
                                 dim=-1)

        def z(x):
            mu = x.mean(dim=-1, keepdim=True)
            sd = x.std(dim=-1, keepdim=True, unbiased=False)
            return (x - mu) / (sd + 1e-8)
        scores = z(scores) + blend * z(typ)
    idx = torch.argmax(scores, dim=-1)                    # (B, A)
    idx = idx[..., None, None, None].expand(
        idx.shape + (1,) + pred.shape[3:])
    return torch.take_along_dim(pred, idx, dim=2)[:, :, 0]
