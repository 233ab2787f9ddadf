"""Train state and the optimizer (PyTorch port of
``desire_tpu/train/state.py``).

The JAX package trains with ``optax.chain(clip_by_global_norm(grad_clip),
adam(exponential_decay(lr, steps_per_epoch, decay_rate, staircase=True)))``.
This module reproduces that chain step for step, not PyTorch's own
optimizers:

* clip by global norm: g <- g where |g| < max_norm, else (g / |g|) *
  max_norm (no epsilon; a NaN norm fails the test, so every leaf turns
  NaN, as optax's select does), |g| summed over the leaves in the JAX tree
  order, the choice made on the device;
* Adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected moments;
* the rate lr * decay_rate ** floor(count / steps_per_epoch), count being
  the optimizer's own update count before this update.

Parameters are a tree (nested dicts and lists) of float32 tensors; each
update returns a new tree and leaves the old one as it was. The norm, the
clip and Adam run in ``ops.adam``: on the card two kernel launches for
the whole tree, the state's trees views of three flat buffers
(``TrainState.flat``); on the CPU the plain version leaf by leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.ops import adam
from desire_tpu_torch.ops.adam import B1, B2


def tree_leaves(tree):
    """Leaves in the JAX package's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` (tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def global_norm(leaves):
    """sqrt of the sum over leaves of each leaf's sum of squares, a 0-d
    tensor on their device."""
    return adam.global_norm(leaves)


@dataclasses.dataclass
class TrainState:
    """step: updates taken; params: the parameter tree; mu, nu: Adam's
    moments (same tree); count: the optimizer's update count; generator:
    the source of every random draw of the training steps.

    flat: on the card the optimizer's state (``adam.Flat``), of whose
    three buffers params, mu and nu are the trees of views; None on the
    CPU. A state made on the card without it copies its trees into fresh
    buffers in the tree's layout, so that every state there is flat."""
    step: int
    params: dict
    mu: dict
    nu: dict
    count: int
    generator: torch.Generator
    flat: adam.Flat | None = None

    def __post_init__(self):
        if self.flat is not None:
            return
        leaves = tree_leaves(self.params)
        if not leaves[0].is_cuda:
            return
        lay = adam.layout(tuple(x.shape for x in leaves))
        self.flat = adam.Flat(lay, lay.pack(leaves),
                              lay.pack(tree_leaves(self.mu)),
                              lay.pack(tree_leaves(self.nu)))
        self.params, self.mu, self.nu = _trees(self.params, self.flat)


def _trees(like, flat):
    """The (params, mu, nu) trees shaped like ``like`` of the views of the
    buffers of ``flat``."""
    return tuple(tree_unflatten(like, flat.layout.views(x))
                 for x in (flat.params, flat.mu, flat.nu))


class Update(tuple):
    """``apply_updates``' (params, mu, nu, count) of the new state, with
    ``flat``: on the card the new ``adam.Flat``, whose buffers the three
    trees view; None on the CPU."""

    def __new__(cls, params, mu, nu, count, flat=None):
        self = super().__new__(cls, (params, mu, nu, count))
        self.flat = flat
        return self


def learning_rate(cfg: DesireConfig, steps_per_epoch: int, count: int):
    """optax.exponential_decay(staircase=True) at update count ``count``,
    in float32."""
    epochs = count // max(int(steps_per_epoch), 1)
    decay = torch.tensor(cfg.decay_rate, dtype=torch.float32) ** epochs
    return torch.tensor(cfg.learning_rate, dtype=torch.float32) * decay


def create_train_state(cfg: DesireConfig, params, seed=None) -> TrainState:
    """Fresh state: step 0, zero moments, a generator seeded with ``seed``
    (cfg.seed by default) on the params' device. On the card the state's
    params are a copy of ``params`` (``TrainState.flat``)."""
    leaves = tree_leaves(params)
    gen = torch.Generator(device=leaves[0].device)
    gen.manual_seed(cfg.seed if seed is None else int(seed))
    zeros = tree_unflatten(params, [torch.zeros_like(x) for x in leaves])
    zeros2 = tree_unflatten(params, [torch.zeros_like(x) for x in leaves])
    return TrainState(step=0, params=params, mu=zeros, nu=zeros2, count=0,
                      generator=gen)


@torch.no_grad()
def apply_updates(cfg: DesireConfig, steps_per_epoch: int,
                  state: TrainState, grads, g_norm=None) -> Update:
    """One optimizer update from the gradients ``grads``, a tree like the
    params or its leaves in ``tree_leaves`` order. g_norm: their global
    norm (``global_norm``), computed here when not given. Returns the
    ``Update`` (params, mu, nu, count) of the new state, in fresh memory:
    ``state`` is left as it was."""
    g_l = tree_leaves(grads)
    if g_norm is None:
        g_norm = global_norm(g_l)
    count = state.count + 1
    lr = learning_rate(cfg, steps_per_epoch, state.count)
    bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** count
    bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** count
    args = (g_norm, float(cfg.grad_clip), lr, bc1, bc2)
    if state.flat is not None:
        flat = adam.clip_adam(state.flat, g_l, *args)
        return Update(*_trees(state.params, flat), count, flat)
    new = adam.clip_adam_plain(tree_leaves(state.params), g_l,
                               tree_leaves(state.mu), tree_leaves(state.nu),
                               *args)
    return Update(*(tree_unflatten(state.params, x) for x in new), count)
