"""A minimal worked example (PyTorch port of ``examples/toy_gaussian.py``):
a dense(2 -> 5) layer maps each agent's position to a bivariate Gaussian
over its next offset, trained with the masked NLL by RMSProp on the SDD
loader's batches.

    python -m desire_tpu_torch.examples.toy_gaussian --data_dir DATA \\
        [--scenes coupa] [--steps 200] [--device cuda|cpu]

The flags are the JAX example's, with ``--device`` (default cuda; it
raises without a CUDA device) in place of ``--platform``. The optimizer
is optax's ``rmsprop(1e-3)``, written out (:func:`rmsprop_update`): decay
0.9, eps inside the square root, the second moment starting at 0 —
``torch.optim.RMSprop`` differs in all three defaults' places.
"""

from __future__ import annotations

import argparse

import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.data.loader import SDDLoader
from desire_tpu_torch.models import layers as L
from desire_tpu_torch.models import losses
from desire_tpu_torch.params import require_device
from desire_tpu_torch.train.trainer import batch_to_device

LEARNING_RATE = 1e-3
DECAY = 0.9
EPS = 1e-8


def toy_config(data_dir: str, scenes: str = "") -> DesireConfig:
    """The example's windows: 4 observed steps and 1 to predict, 32
    windows of at most 16 agents a batch."""
    return DesireConfig(batch_size=32, max_num_obj=16, obs_len=4,
                        pred_len=1, data_dir=data_dir, scenes=scenes,
                        window_hop=4)


def init_params(device, seed: int = 0) -> dict:
    """{"head": dense(2 -> 5)}, drawn from ``seed`` on the CPU."""
    head = L.init_dense(torch.Generator().manual_seed(seed), 2, 5, "cpu")
    return {"head": {n: t.to(device) for n, t in head.items()}}


def loss_fn(params, xy, mask, ids):
    """The masked mean NLL of each agent's next offset under the Gaussian
    of its current position. xy (B, T, A, 2), mask (B, T, A), ids (B, A)."""
    cur, nxt = xy[:, -2], xy[:, -1]
    m = mask[:, -2] * mask[:, -1] * (ids > 0).to(xy.dtype)
    raw = L.dense(params["head"], cur)
    nll = losses.bivariate_nll(raw, nxt - cur)
    return losses.masked_mean(nll, m)


def rmsprop_init(params) -> dict:
    return {k: {n: torch.zeros_like(t) for n, t in v.items()}
            for k, v in params.items()}


@torch.no_grad()
def rmsprop_update(params, grads, nu, lr=LEARNING_RATE, decay=DECAY,
                   eps=EPS):
    """optax.rmsprop's step: nu = decay nu + (1 - decay) g^2, then
    p - lr g / sqrt(nu + eps). Returns (params, nu)."""
    new_p, new_nu = {}, {}
    for k, v in params.items():
        new_p[k], new_nu[k] = {}, {}
        for n, p in v.items():
            g = grads[k][n]
            m = (1.0 - decay) * (g * g) + decay * nu[k][n]
            new_nu[k][n] = m
            new_p[k][n] = p + (-lr) * (g * torch.rsqrt(m + eps))
    return new_p, new_nu


def train_step(params, nu, xy, mask, ids):
    """One RMSProp step. Returns (params, nu, loss before the step)."""
    leaves = {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
              for k, v in params.items()}
    loss = loss_fn(leaves, xy, mask, ids)
    flat = [t for v in leaves.values() for t in v.values()]
    got = iter(torch.autograd.grad(loss, flat))
    grads = {k: {n: next(got) for n in v} for k, v in leaves.items()}
    params, nu = rmsprop_update(params, grads, nu)
    return params, nu, loss.detach()


def train(loader, steps: int, device, log=print):
    """``steps`` steps over the loader's epochs, as the JAX example walks
    them (a step that finds an epoch's end starts the next epoch and
    trains nothing). Returns (params, nu, losses)."""
    params = init_params(device)
    nu = rmsprop_init(params)
    losses_out = []
    it = None
    for i in range(steps):
        if it is None:
            it = loader.epoch_batches(i // max(loader.num_batches, 1))
        try:
            b = next(it)
        except StopIteration:
            it = None
            continue
        xy, mask, ids = batch_to_device(b, device)[:3]
        params, nu, loss = train_step(params, nu, xy, mask, ids)
        losses_out.append(loss)
        if i % 20 == 0:
            log(f"step {i:4d}  nll {float(loss):8.4f}")
    return params, nu, losses_out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="data/")
    ap.add_argument("--scenes", default="")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (needs a CUDA device) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    loader = SDDLoader(toy_config(args.data_dir, args.scenes))
    _, _, out = train(loader, args.steps, device)
    print("final nll:", float(out[-1]) if out else float("nan"))


if __name__ == "__main__":
    main()
