"""Masks shared by the model (port of the inference part of
``desire_tpu/models/losses.py``; the training losses come with the training
slice)."""

from __future__ import annotations

import torch


def agent_validity_mask(src_ids, tgt_ids=None):
    """Live-agent mask: id 0 marks an empty slot. An agent must exist in
    both the source and, when given, the target frames."""
    live = src_ids != 0
    if tgt_ids is not None:
        live = live & (tgt_ids != 0)
    return live.to(torch.float32)
