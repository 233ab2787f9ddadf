"""The benchmark's FLOP counts: ``FlopCounterMode`` (matmuls and
convolutions) over the reference at a cell's shapes, on the meta device,
so no arithmetic runs and any size counts in a moment.

    python3 -m benchmark_torch.flops desire_flagship 64 60 20

prints the forward's and the training step's counts, which the
configuration's file records under ``flops`` by shape (``work.shape_key``).
"""

from __future__ import annotations

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark_torch import work
from benchmark_torch.reference import model as ref
from benchmark_torch.reference import params as ref_params


def _meta_params(cfg):
    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return torch.zeros(t, device="meta")
    return build(ref_params.shapes(cfg))


def _inputs(cfg, b, a, k, device):
    t = cfg["obs_len"] + cfg["pred_len"]
    z = dict(device=device)
    return (torch.zeros((b, t, a, 2), **z), torch.ones((b, t, a), **z),
            torch.ones((b, a), dtype=torch.int64, **z),
            torch.zeros((b * a, k, cfg["latent_size"]), **z))


def count(cfg, b, a, k, train=False, device="meta"):
    """FLOPs of the reference's forward (train=False) or one training step
    (the loss's forward and backward) at (b, a, k)."""
    params = (_meta_params(cfg) if device == "meta"
              else ref_params.make_params(cfg, 0, device))
    xy, mask, ids, eps = _inputs(cfg, b, a, k, device)
    with FlopCounterMode(display=False) as counter:
        if not train:
            with torch.no_grad():
                ref.forward(params, cfg, xy, mask, ids, eps)
        else:
            to, emb = cfg["obs_len"], cfg["embedding_size"]
            tf = cfg["pred_len"]
            noise = {"eps": eps,
                     "lane_u": torch.zeros((b, a, k), device=device),
                     "keep_x": torch.ones((b * a, to, emb), device=device),
                     "keep_y": torch.ones((b * a, tf, emb), device=device)}
            leaves = [x.requires_grad_(True)
                      for x in ref_params.leaves(params)]
            total, _ = ref.loss(ref_params.unflatten(params, leaves), cfg,
                                xy, mask, ids, noise, 0)
            torch.autograd.grad(total, leaves, allow_unused=True)
    return int(counter.get_total_flops())


def recorded(config, model, b, a, k, train):
    """The configuration file's count at these shapes where ``model`` is
    the file's, else counted now."""
    key = "step" if train else "forward"
    got = None
    if model == config["model"]:
        got = config.get("flops", {}).get(key, {}).get(
            work.shape_key(b, a, k))
    return got if got is not None else count(model, b, a, k, train)


if __name__ == "__main__":
    name, b, a, k = sys.argv[1], *map(int, sys.argv[2:5])
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", name + ".json")) as fh:
        model = json.load(fh)["model"]
    print(json.dumps({"forward": {work.shape_key(b, a, k):
                                  count(model, b, a, k)},
                      "step": {work.shape_key(b, a, k):
                               count(model, b, a, k, train=True)}}))
