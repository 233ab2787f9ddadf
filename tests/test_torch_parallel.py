"""The port's parallel layer (desire_tpu_torch/parallel) on the CPU: the
mesh, the loader's row hook and, in one 4-rank gloo world (this file run
as a script, one process a rank), the sharded sampler and IOC ops, the
meshed forward and Predictor, the data-parallel training step and epoch,
and lane-parallel training (the sharded trainable IOC, the (2, 2) loss
and step), each held against the unsharded port and the JAX package.

Tolerances: float32; a meshed result against the unsharded port within
rtol = atol = 1e-5 (the same arithmetic on fewer rows; matrix products
over other row counts may sum in another order), against JAX within the
port's own JAX parity tolerances (tests/test_torch_desire.py,
tests/test_torch_train.py). JAX is imported only by the tests, never by
the ranks.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.models import desire as tdesire
from desire_tpu_torch.ops import ioc_fused, sgm_fused
from desire_tpu_torch.parallel import mesh as mesh_mod
from desire_tpu_torch.params import init_desire, to_numpy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds a collective may wait, and the whole spawn: the ranks compete for
# the CPU with the other test workers
_PG_TIMEOUT = 180.0
_WALL = 180.0
MESHED_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
JAX_SCORE_TOL = dict(rtol=2e-4, atol=2e-4)
_WORLD = 4


def small_cfg(**kw):
    """tests/test_parallel.py small_cfg's toy model, with the variety
    subset on (variety_k 3 of 4 lanes) and the default dropout and speed
    weights."""
    base = dict(batch_size=8, max_num_obj=4, obs_len=4, pred_len=4,
                num_samples=4, d_dim=16, latent_size=8, embedding_size=8,
                channel_multiplier=10, scene_grid=8, scene_channels=4,
                num_refine=2, compute_dtype="float32", kld_warmup=0,
                rnn_size=128, variety_k=3, subsample=2, window_hop=2,
                save_dir="")
    base.update(kw)
    return DesireConfig(**base)


def _params(cfg):
    """The port's init with the zero-init heads made non-zero
    (tests/test_torch_desire.py), on the CPU."""
    p = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    for sub, name in (("sgm", "prior"), ("sgm", "ztemp_fc2"),
                      ("ioc", "delta"), ("ioc", "gate")):
        w = p[sub][name]["w"]
        p[sub][name]["w"] = torch.from_numpy(
            (0.3 * rng.standard_normal(w.shape)).astype(np.float32))
    return p


def _batch(cfg, b, seed=0):
    """xy (B, T, A, 2), mask, ids: the last agent dead, one observed step
    of agent 0 masked, one agent without a future."""
    a, t = cfg.max_num_obj, cfg.total_len
    rng = np.random.default_rng(seed)
    xy = (rng.uniform(size=(b, t, a, 2)) * 0.5 + 0.25).astype(np.float32)
    mask = np.ones((b, t, a), np.float32)
    mask[:, :, -1] = 0.0
    mask[0, 0, 0] = 0.0
    mask[1, cfg.obs_len:, 1] = 0.0
    ids = np.tile(np.arange(1, a + 1), (b, 1)).astype(np.float32)
    ids[:, -1] = 0.0
    return xy, mask, ids


def _sampler_inputs(cfg, n, seed=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    obs = np.ones((n, cfg.obs_len), np.float32)
    obs[3, :2] = 0.0
    return dict(feats=np.abs(f(n, cfg.obs_len, cfg.embedding_size)),
                obs_mask=obs, rho_seed=np.abs(f(n, cfg.d_dim)),
                eps=f(n, cfg.num_samples, cfg.latent_size))


def _ioc_inputs(cfg, b, seed=3):
    rng = np.random.default_rng(seed)
    a, k, t, d = cfg.max_num_obj, cfg.num_samples, cfg.pred_len, cfg.d_dim
    g, c = cfg.scene_grid, cfg.scene_channels
    live = np.ones((b, a), np.float32)
    live[:, -1] = 0.0
    fut = np.ones((b, a, t), np.float32)
    fut[0, 1, 2:] = 0.0
    return dict(
        traj=rng.uniform(0.2, 0.8, (b, a, k, t, 2)).astype(np.float32),
        dec_h=np.tanh(rng.standard_normal((b, a, k, t, d))).astype(
            np.float32),
        feat_map=rng.standard_normal((b, g, g, c)).astype(np.float32),
        live=live, fut_mask=fut)


def _windows(cfg, count, seed):
    """count windows of straight-line agents in raw pixels."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        na = 2 + i % (cfg.max_num_obj - 1)
        t = np.arange(cfg.obs_len, dtype=np.float32)
        p0 = rng.uniform(20, 60, (na, 2)).astype(np.float32)
        v = rng.uniform(-2.0, 2.0, (na, 2)).astype(np.float32)
        out.append((p0[:, None] + v[:, None] * t[None, :, None],
                    np.ones((na, cfg.obs_len), np.float32),
                    np.arange(1, na + 1, dtype=np.int64)))
    return out


def _write_tree(root, frames=120):
    """One scene, one video of agents on straight lines: 27 windows of
    subsample 2, hop 2 at To = Tf = 4 (3 batches of 8, 6 of 4)."""
    rng = np.random.RandomState(0)
    path = os.path.join(str(root), "scene/video0/annotations_processed.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    recs = []
    for aid in range(1, 6):
        v, p0 = rng.uniform(-1.5, 1.5, 2), rng.uniform(20, 80, 2)
        recs += [(f, aid, *(p0 + v * f)) for f in range(frames)]
    with open(path, "w") as f:
        for row in np.asarray(recs, np.float64).T:
            f.write(",".join(f"{x:g}" for x in row) + "\n")
    return str(root)


_FORWARD_VARIANTS = {"fused": {}, "layer_sgm": dict(use_pallas=False),
                     "layer_ioc": dict(use_social=False)}
_FORWARD_KEYS = ("raw5", "sgm_traj", "refined_traj", "scores", "zp_mu",
                 "zp_logvar", "live")
_PREDICT_KEYS = ("ids", "live", "traj", "scores", "best")
_FWD_B, _PRED_WINDOWS, _EPOCH_BATCHES = 4, 4, 3


# -- the ranks (this file run as a script) ------------------------------------

def _rank_main(rank, port, workdir):
    from desire_tpu_torch.serve import Predictor
    from desire_tpu_torch.train import trainer
    from desire_tpu_torch.train.state import create_train_state, tree_leaves

    torch.set_num_threads(1)
    mesh_mod.init_multihost(f"localhost:{port}", _WORLD, rank, "cpu",
                            timeout_s=_PG_TIMEOUT)
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    T = torch.from_numpy
    out, info = {}, {}

    def mesh(*a, **kw):
        return mesh_mod.make_mesh(*a, device="cpu", timeout_s=_PG_TIMEOUT,
                                  **kw)

    m22 = mesh(2, 2)
    info["coords"] = list(m22.coords)
    info["shape_k2"] = list(mesh(k=2).shape)
    info["shape_k4"] = list(mesh(k=4).shape)
    for name, kw in (("exceeds", dict(data=8)), ("indivisible", dict(k=3))):
        try:
            mesh(**kw)
            info[name] = "no error"
        except AssertionError as e:
            info[name] = str(e)

    cfg = small_cfg()
    params = _params(cfg)
    n = len(inp["s_feats"])
    r = m22.rows(n)
    dec_h, hx = sgm_fused.sgm_sample_decode_sharded(
        m22, params["sgm"], T(inp["s_feats"][r]), T(inp["s_obs_mask"][r]),
        T(inp["s_rho_seed"][r]), T(inp["s_eps"][r]), cfg.pred_len)
    k = cfg.num_samples
    out["sgm_dec_h"], = mesh_mod.assemble(
        m22, [(dec_h, (n, k) + dec_h.shape[2:])], lane_dim=1)
    out["sgm_hx"], = mesh_mod.assemble(m22, [(hx, (n,) + hx.shape[1:])])

    b = len(inp["i_traj"])
    r, ln = m22.rows(b), m22.lanes(k)
    refined, scores = ioc_fused.ioc_refine_sharded(
        m22, params["ioc"], params["scf"],
        T(inp["i_traj"][r][:, :, ln].copy()),
        T(inp["i_dec_h"][r][:, :, ln].copy()), T(inp["i_feat_map"][r]),
        T(inp["i_live"][r]), T(inp["i_fut_mask"][r]),
        num_refine=cfg.num_refine, delta_scale=0.1)
    out["ioc_refined"], out["ioc_scores"] = mesh_mod.assemble(
        m22, [(refined, (b,) + refined.shape[1:2] + (k,)
               + refined.shape[3:]), (scores, (b,) + scores.shape[1:2]
                                      + (k,))], lane_dim=2)

    batch = [T(inp[f"f_{x}"]) for x in ("xy", "mask", "ids")]
    for name, variant in _FORWARD_VARIANTS.items():
        vcfg = small_cfg(**variant)
        got = tdesire.desire_forward(params, vcfg, *batch,
                                     eps=T(inp["f_eps"]), mesh=m22)
        for key in _FORWARD_KEYS:
            out[f"fwd_{name}_{key}"] = got[key].numpy()
    # K = 3 lanes do not split over k = 2: every rank runs the whole batch
    got = tdesire.desire_forward(params, cfg, *batch, k_samples=3,
                                 eps=T(inp["f_eps"][:, :3].copy()), mesh=m22)
    for key in _FORWARD_KEYS:
        out[f"fwd_k3_{key}"] = got[key].numpy()

    pred = Predictor(params, cfg, device="cpu", max_windows=_PRED_WINDOWS,
                     mesh=m22)
    # the other ranks' windows differ: rank 0's are broadcast
    wins = _windows(cfg, _PRED_WINDOWS, seed=0 if rank == 0 else 9)
    scales = [100.0, 50.0, 80.0, 120.0] if rank == 0 else 1.0
    for i, rec in enumerate(pred.predict_windows(wins, scales)):
        for key in _PREDICT_KEYS:
            out[f"pred{i}_{key}"] = rec[key]
    try:
        Predictor(params, cfg, device="cpu", max_windows=3, mesh=m22)
        info["predictor_odd_windows"] = "no error"
    except ValueError as e:
        info["predictor_odd_windows"] = str(e)

    # lane-parallel training on the (2, 2) mesh: the sharded trainable IOC,
    # the loss's gradients in three IOC variants and one step
    for freeze in (False, True):
        out[f"ioc_train_freeze{int(freeze)}"] = ioc_train_flat(
            m22, params, inp, freeze)
    rows22 = [T(inp[f"t_{x}"][m22.rows(cfg.batch_size)]) for x in
              ("xy", "mask", "ids")]
    noise22 = {key[4:]: T(v) for key, v in inp.items()
               if key.startswith("j22_")}
    for name, variant in _LANE_VARIANTS.items():
        out[f"grads22_{name}"] = loss_grads_flat(
            m22, small_cfg(**variant), _params(cfg), rows22, noise22)
    new, met = trainer.make_train_step(cfg, 10, mesh=m22)(
        create_train_state(cfg, _params(cfg)), *rows22, noise=noise22)
    out["step22_params"] = np.concatenate(
        [x.numpy().ravel() for x in tree_leaves(new.params)])
    for key, v in met.items():
        out[f"step22_{key}"] = float(v)

    # data parallel: four ranks of two rows each
    m41 = mesh(4, 1)
    r = m41.rows(cfg.batch_size)
    noise = {key[6:]: T(v) for key, v in inp.items()
             if key.startswith("noise_")}
    rows = [T(inp[f"t_{x}"][r]) for x in ("xy", "mask", "ids")]
    state = create_train_state(cfg, _params(cfg))
    new, met = trainer.make_train_step(cfg, 10, mesh=m41)(
        state, *rows, noise=noise)
    out["step_params"] = np.concatenate(
        [x.numpy().ravel() for x in tree_leaves(new.params)])
    for key, v in met.items():
        out[f"step_{key}"] = float(v)
    out["grads"] = loss_grads_flat(m41, cfg, state.params, rows, noise)

    # run_epoch over the loader's rows of 3 batches, with the JAX step's
    # draws pinned step by step
    from desire_tpu_torch.data.loader import SDDLoader
    ecfg = small_cfg(data_dir=inp["tree"].item())
    loader = SDDLoader(ecfg, use_native=False)
    step_fn = trainer.make_train_step(ecfg, loader.num_batches, mesh=m41)
    draws = iter([{key[len(f"epoch{i}_"):]: T(v) for key, v in inp.items()
                   if key.startswith(f"epoch{i}_")}
                  for i in range(_EPOCH_BATCHES)])
    logged = []
    trainer.run_epoch(
        create_train_state(ecfg, _params(ecfg)), loader, 0,
        lambda st, *bt: step_fn(st, *bt, noise=next(draws)),
        log_fn=lambda m, st: logged.append(m["loss"]), log_every=1,
        max_batches=_EPOCH_BATCHES, mesh=m41)
    out["epoch_losses"] = np.asarray(logged)

    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    mesh_mod.barrier(m22)
    torch.distributed.destroy_process_group()


_LANE_VARIANTS = {"fused": {}, "layer_ioc": dict(fused_train=False),
                  "no_social": dict(use_social=False)}


def ioc_train_flat(mesh, params, inp, social_freeze):
    """tests/test_kernels.py:388's loss of the trainable IOC on the inputs
    i_*: its value and its gradients (the IOC and message leaves, traj,
    dec_h, feat_map) as one float32 array. mesh None: ``ioc_refine_train``
    on every row; a mesh: this rank's rows through
    ``ioc_refine_train_sharded``, its value and gradients (global shapes,
    its rows filled) summed over the mesh and divided by mk, as the
    training step reduces them."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.models.ioc import _DELTA_SCALE
    from desire_tpu_torch.train.state import tree_leaves, tree_unflatten
    b = len(inp["i_traj"])
    r = slice(None) if mesh is None else mesh.rows(b)
    T = lambda key: torch.from_numpy(inp[key][r].copy())
    trees = {"ioc": params["ioc"],
             "scf": {"soc_msg": params["scf"]["soc_msg"],
                     "soc_logtau": params["scf"]["soc_logtau"]}}
    leaves = [x.detach().clone().requires_grad_(True)
              for x in tree_leaves(trees)]
    trees = tree_unflatten(trees, leaves)
    data = [T(f"i_{k}").requires_grad_(True)
            for k in ("traj", "dec_h", "feat_map")]
    kw = dict(num_refine=2, delta_scale=_DELTA_SCALE,
              social_freeze=social_freeze)
    args = (trees["ioc"], trees["scf"], *data, T("i_live"),
            T("i_fut_mask"))
    if mesh is None:
        refined, scores, iters = ops.ioc_refine_train(*args, **kw)
    else:
        refined, scores, iters = ops.ioc_refine_train_sharded(mesh, *args,
                                                              **kw)
    value = ((refined ** 2).sum() + (scores * T("i_wts")).sum()
             + (iters ** 2).sum())
    grads = torch.autograd.grad(value, leaves + data)
    parts = [value.detach().reshape(1)]
    parts += [g.reshape(-1) for g in grads[:len(leaves)]]
    for g, x in zip(grads[len(leaves):], ("traj", "dec_h", "feat_map")):
        full = torch.zeros(inp[f"i_{x}"].shape)
        full[r] = g
        parts.append(full.reshape(-1))
    flat = torch.cat(parts)
    if mesh is not None:
        flat = mesh_mod.all_sum(mesh, flat, axis=mesh_mod.MESH) / \
            mesh.shape[1]
    return flat.numpy()


def loss_grads_flat(mesh, cfg, params, batch, noise):
    """desire_loss's parameter gradients as one flat array, with the step's
    draws ``noise`` (global; a rank takes its rows). mesh None: the whole
    batch; a mesh: its rows of it, the gradients summed over the mesh and
    divided by mk (the training step's reduction)."""
    from desire_tpu_torch.train.state import tree_leaves, tree_unflatten
    leaves = [x.detach().clone().requires_grad_(True)
              for x in tree_leaves(params)]
    if mesh is not None:
        noise = {k: v[mesh.rows(v.shape[0])] for k, v in noise.items()}
    total, _ = tdesire.desire_loss(tree_unflatten(params, leaves), cfg,
                                   *batch, step=0, noise=noise, mesh=mesh)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    flat = torch.cat([(torch.zeros_like(x) if g is None else g).ravel()
                      for g, x in zip(grads, leaves)])
    if mesh is not None:
        flat = mesh_mod.all_sum(mesh, flat, axis=mesh_mod.MESH) / \
            mesh.shape[1]
    return flat.numpy()


# -- the parent: inputs, references, the spawn --------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(script, args_of_rank, world, env=None, wall=_WALL):
    """Start one process per rank (``python script *args_of_rank(r)``),
    wait at most ``wall`` seconds for all, and fail with every rank's log
    when one fails or the time runs out (the others are killed)."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, script, *args_of_rank(r)],
                              env=env, cwd=_REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [""] * world
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=wall)[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                logs[r] += p.communicate()[0]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        pytest.fail(f"ranks {failed} failed or timed out:\n" + "\n".join(
            f"--- rank {r} ---\n{lg}" for r, lg in enumerate(logs)))
    return logs


def _jax_loss_draws(cfg, key):
    """The draws of JAX desire_loss(key=key) on a batch of
    cfg.batch_size, as numpy."""
    import jax
    key, k_lanes = jax.random.split(key)
    k_eps, kdx, kdy = jax.random.split(key, 3)
    n, k = cfg.batch_size * cfg.max_num_obj, cfg.num_samples
    out = {"eps": jax.random.normal(k_eps, (n, k, cfg.latent_size)),
           "keep_x": jax.random.bernoulli(
               kdx, cfg.keep_prob, (n, cfg.obs_len, cfg.embedding_size)),
           "keep_y": jax.random.bernoulli(
               kdy, cfg.keep_prob, (n, cfg.pred_len, cfg.embedding_size)),
           "lane_u": jax.random.uniform(
               k_lanes, (cfg.batch_size, cfg.max_num_obj, k))}
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _jax_epoch_draws(cfg, key, steps):
    """The draws of JAX run_epoch's first steps from state key ``key``
    (speed_aug 0: desire_loss(key=sub) of each step's split), as numpy."""
    import jax
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_jax_loss_draws(cfg, sub))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank spawn: its inputs, and each rank's outputs."""
    import jax
    workdir = tmp_path_factory.mktemp("mesh")
    cfg = small_cfg()
    xy, mask, ids = _batch(cfg, _FWD_B)
    key = jax.random.PRNGKey(5)
    f_eps = np.array(jax.random.normal(
        jax.random.split(key, 3)[0],
        (_FWD_B * cfg.max_num_obj, cfg.num_samples, cfg.latent_size)))
    rng = np.random.default_rng(7)
    n = cfg.batch_size * cfg.max_num_obj
    noise = {"eps": rng.standard_normal(
                 (n, cfg.num_samples, cfg.latent_size)),
             "lane_u": rng.random((cfg.batch_size, cfg.max_num_obj,
                                   cfg.num_samples)),
             "keep_x": rng.random((n, cfg.obs_len, cfg.embedding_size))
             < cfg.keep_prob,
             "keep_y": rng.random((n, cfg.pred_len, cfg.embedding_size))
             < cfg.keep_prob}
    inp = {f"s_{k}": v for k, v in _sampler_inputs(cfg, 16).items()}
    inp.update({f"i_{k}": v for k, v in _ioc_inputs(cfg, 4).items()})
    inp["i_wts"] = rng.standard_normal(
        (4, cfg.max_num_obj, cfg.num_samples)).astype(np.float32)
    inp.update(f_xy=xy, f_mask=mask, f_ids=ids, f_eps=f_eps)
    t_xy, t_mask, t_ids = _batch(cfg, cfg.batch_size, seed=4)
    inp.update(t_xy=t_xy, t_mask=t_mask, t_ids=t_ids)
    inp.update({f"noise_{k}": np.asarray(v, np.float32)
                for k, v in noise.items()})
    tree = _write_tree(workdir / "data")
    inp["tree"] = np.asarray(tree)
    for i, d in enumerate(_jax_epoch_draws(cfg, jax.random.PRNGKey(11),
                                           _EPOCH_BATCHES)):
        inp.update({f"epoch{i}_{k}": v for k, v in d.items()})
    # the (2, 2) step's draws: the JAX step's from state key 12
    inp.update({f"j22_{k}": v for k, v in _jax_epoch_draws(
        cfg, jax.random.PRNGKey(12), 1)[0].items()})
    np.savez(workdir / "inputs.npz", **inp)
    port = _free_port()
    env = dict(os.environ, DESIRE_TORCH_CACHE_DIR=str(workdir / "cache"))
    spawn(__file__, lambda r: [str(r), str(port), str(workdir)], _WORLD,
          env=env)
    ranks = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(_WORLD)]
    infos = [json.load(open(workdir / f"rank{r}.json"))
             for r in range(_WORLD)]
    return dict(cfg=cfg, inp=inp, ranks=ranks, infos=infos)


def _all_ranks_equal(world, key):
    for r in range(1, _WORLD):
        np.testing.assert_array_equal(world["ranks"][r][key],
                                      world["ranks"][0][key], err_msg=key)
    return world["ranks"][0][key]


def _jax_tree(params):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, to_numpy(params))


# -- the mesh and the loader's rows (no spawn) --------------------------------

def test_make_mesh_one_process():
    """tests/test_parallel.py:35 in one process: the mesh is (1, 1), and
    one that needs more devices than ranks fails."""
    m = mesh_mod.make_mesh(device="cpu")
    assert (m.shape, m.coords, m.device) == ((1, 1), (0, 0),
                                             torch.device("cpu"))
    assert m.rows(6) == slice(0, 6) and m.lanes(5) == slice(0, 5)
    with pytest.raises(AssertionError, match="exceeds 1 devices"):
        mesh_mod.make_mesh(2, 1, device="cpu")
    with pytest.raises(AssertionError, match="not divisible"):
        mesh_mod.make_mesh(k=2, device="cpu")
    mesh_mod.init_multihost("", None, None)     # no coordinator: a no-op
    assert mesh_mod.process_count() == 1


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
def test_local_batch_rows_match_jax_sharding(shape):
    """Every rank's rows equal the block that JAX's P('data') gives its
    device on the 8-device CPU mesh."""
    from jax.sharding import NamedSharding, PartitionSpec
    from desire_tpu.parallel import mesh as jmesh
    jm = jmesh.make_mesh(*shape)
    idx = NamedSharding(jm, PartitionSpec("data")).devices_indices_map((16,))
    for rank in range(shape[0] * shape[1]):
        m = mesh_mod.Mesh(shape, (rank // shape[1], rank % shape[1]),
                          torch.device("cpu"), {})
        want = np.arange(16)[idx[jm.devices[m.coords]][0]]
        np.testing.assert_array_equal(mesh_mod.local_batch_rows(m, 16),
                                      want)
    with pytest.raises(ValueError, match="do not split"):
        mesh_mod.local_batch_rows(m, 15)


@pytest.mark.parametrize("shape,rank,epoch,start", [
    ((2, 1), 1, 0, 0), ((4, 1), 2, 1, 1), ((2, 2), 3, 2, 2)])
def test_loader_rows_match_jax(tmp_path, monkeypatch, shape, rank, epoch,
                               start):
    """The loader's rows hook against the JAX loader's, bit for bit, also
    resumed at a batch."""
    from desire_tpu.config import DesireConfig as JConfig
    from desire_tpu.data.loader import SDDLoader as JLoader
    from desire_tpu_torch.data.loader import SDDLoader
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "jcache"))
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "tcache"))
    kw = dict(batch_size=4, max_num_obj=4, obs_len=4, pred_len=4,
              subsample=2, window_hop=2, data_dir=_write_tree(tmp_path),
              save_dir="")
    m = mesh_mod.Mesh(shape, (rank // shape[1], rank % shape[1]),
                      torch.device("cpu"), {})
    rows = mesh_mod.local_batch_rows(m, 4)
    loader = SDDLoader(DesireConfig(**kw), use_native=False)
    got = list(loader.epoch_batches(epoch, start, rows=rows))
    want = list(JLoader(JConfig(**kw), use_native=False)
                .epoch_batches(epoch, start, rows=rows))
    assert len(got) == len(want) == loader.num_batches - start == 6 - start
    for g, w in zip(got, want):
        assert g.xy.shape[0] == len(rows)
        for name in ("xy", "mask", "ids", "video", "scale"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name), err_msg=name)


def test_meshed_loss_needs_the_step_draws():
    """Under a mesh the loss takes the rank's rows of the global draws:
    drawing its own would give every rank the same noise."""
    cfg = small_cfg()
    m = mesh_mod.Mesh((2, 1), (0, 0), torch.device("cpu"), {})
    xy, mask, ids = map(torch.from_numpy, _batch(cfg, 4))
    with pytest.raises(ValueError, match="global draws"):
        tdesire.desire_loss(_params(cfg), cfg, xy, mask, ids, mesh=m)


# -- the 4-rank world ------------------------------------------------------------

def test_mesh_shapes_in_four_ranks(world):
    """tests/test_parallel.py:35 in a world of 4 ranks."""
    for r, info in enumerate(world["infos"]):
        assert info["coords"] == [r // 2, r % 2]
        assert info["shape_k2"] == [2, 2] and info["shape_k4"] == [1, 4]
        assert info["exceeds"] == "mesh 8x1 exceeds 4 devices"
        assert info["indivisible"] == "4 devices not divisible by k=3"


def test_sharded_sampler_matches_unsharded_and_jax(world):
    """tests/test_kernels.py:527: the (2, 2) sampler shards against the
    unsharded op and the JAX sharded Pallas op (interpret mode)."""
    import jax.numpy as jnp
    from desire_tpu.ops.sgm_fused import sgm_sample_decode_fused_sharded
    from desire_tpu.parallel import mesh as jmesh
    cfg, inp = world["cfg"], world["inp"]
    p = _params(cfg)["sgm"]
    args = [inp[f"s_{k}"] for k in ("feats", "obs_mask", "rho_seed", "eps")]
    ref = sgm_fused.sgm_sample_decode_plain(
        p, *map(torch.from_numpy, args), cfg.pred_len)
    jref = sgm_sample_decode_fused_sharded(
        jmesh.make_mesh(2, 2), _jax_tree(p), *map(jnp.asarray, args),
        cfg.pred_len, interpret=True)
    for i, key in enumerate(("sgm_dec_h", "sgm_hx")):
        got = _all_ranks_equal(world, key)
        np.testing.assert_allclose(got, ref[i].numpy(), **MESHED_TOL)
        np.testing.assert_allclose(got, np.asarray(jref[i]), **JAX_TOL)


def test_sharded_ioc_matches_unsharded_and_jax(world):
    """tests/test_kernels.py:313: the (2, 2) IOC shards against the
    unsharded op and the JAX sharded Pallas op (interpret mode)."""
    import jax.numpy as jnp
    from desire_tpu.models import scf as jscf
    from desire_tpu.ops.ioc_fused import ioc_refine_fused_sharded
    from desire_tpu.parallel import mesh as jmesh
    cfg, inp = world["cfg"], world["inp"]
    p = _params(cfg)
    args = [inp[f"i_{k}"] for k in ("traj", "dec_h", "feat_map", "live",
                                    "fut_mask")]
    kw = dict(num_refine=cfg.num_refine, delta_scale=0.1)
    ref = ioc_fused.ioc_refine_plain(p["ioc"], p["scf"],
                                     *map(torch.from_numpy, args), **kw)
    jp = _jax_tree(p)
    ja = list(map(jnp.asarray, args))
    msg = jscf.social_messages(jp["scf"], ja[1])
    jref = ioc_refine_fused_sharded(jmesh.make_mesh(2, 2), jp["ioc"],
                                    jp["scf"], ja[0], ja[1], msg, *ja[2:],
                                    interpret=True, **kw)
    for i, (key, tol) in enumerate((("ioc_refined", JAX_TOL),
                                    ("ioc_scores", JAX_SCORE_TOL))):
        got = _all_ranks_equal(world, key)
        np.testing.assert_allclose(got, ref[i].numpy(), **MESHED_TOL)
        np.testing.assert_allclose(got, np.asarray(jref[i]), **tol)


def _unsharded_forward(world, variant, **kw):
    inp = world["inp"]
    return tdesire.desire_forward(
        _params(world["cfg"]), small_cfg(**variant),
        *[torch.from_numpy(inp[f"f_{x}"]) for x in ("xy", "mask", "ids")],
        **kw)


@pytest.mark.parametrize("name", sorted(_FORWARD_VARIANTS))
def test_meshed_forward_matches_unsharded(world, name):
    """desire_forward(train=False) on the (2, 2) mesh, eps pinned: the
    fused path, the layer-by-layer sampler (lanes cut before the decoder)
    and the layer-by-layer IOC, against the unsharded port."""
    ref = _unsharded_forward(world, _FORWARD_VARIANTS[name],
                             eps=torch.from_numpy(world["inp"]["f_eps"]))
    for key in _FORWARD_KEYS:
        got = _all_ranks_equal(world, f"fwd_{name}_{key}")
        np.testing.assert_allclose(got, ref[key].numpy(), err_msg=key,
                                   **MESHED_TOL)


def test_meshed_forward_matches_jax(world):
    """The meshed fused forward against the JAX forward on the same key
    (tests/test_torch_desire.py's parity, its tolerances)."""
    import jax
    import jax.numpy as jnp
    from desire_tpu.models import desire as jdesire
    cfg, inp = world["cfg"], world["inp"]
    batch = [jnp.asarray(inp[f"f_{x}"]) for x in ("xy", "mask", "ids")]
    ref = jax.jit(lambda p, *bt: jdesire.desire_forward(
        p, cfg, *bt, key=jax.random.PRNGKey(5), train=False))(
            _jax_tree(_params(cfg)), *batch)
    for key in _FORWARD_KEYS:
        tol = JAX_SCORE_TOL if key == "scores" else JAX_TOL
        np.testing.assert_allclose(_all_ranks_equal(world, f"fwd_fused_{key}"),
                                   np.asarray(ref[key]), err_msg=key, **tol)


def test_meshed_forward_indivisible_k_runs_unsharded(world):
    """K = 3 lanes over k = 2: every rank runs the unsharded forward, with
    no collective (the same bits on every rank)."""
    ref = _unsharded_forward(
        world, {}, k_samples=3,
        eps=torch.from_numpy(world["inp"]["f_eps"][:, :3].copy()))
    for key in _FORWARD_KEYS:
        np.testing.assert_allclose(_all_ranks_equal(world, f"fwd_k3_{key}"),
                                   ref[key].numpy(), err_msg=key,
                                   **MESHED_TOL)


def test_meshed_predictor_matches_unmeshed(world):
    """tests/test_serve.py:139: Predictor(mesh=(2, 2)) against the unmeshed
    Predictor with the same seed; the ranks other than 0 were given other
    windows and scales, and still return rank 0's forecasts; max_windows
    must split over data."""
    from desire_tpu_torch.serve import Predictor
    cfg = world["cfg"]
    ref = Predictor(_params(cfg), cfg, device="cpu",
                    max_windows=_PRED_WINDOWS).predict_windows(
        _windows(cfg, _PRED_WINDOWS, seed=0), [100.0, 50.0, 80.0, 120.0])
    for i, rec in enumerate(ref):
        for key in _PREDICT_KEYS:
            got = _all_ranks_equal(world, f"pred{i}_{key}")
            if key in ("ids", "live"):
                np.testing.assert_array_equal(got, rec[key])
            else:
                # pixels: the meshed tolerance times up to 120 px a unit
                np.testing.assert_allclose(got, rec[key], rtol=1e-5,
                                           atol=2e-3, err_msg=key)
    for info in world["infos"]:
        assert "must divide over the data axis" in info[
            "predictor_odd_windows"]


def _unsharded_step(world):
    from desire_tpu_torch.train import trainer
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    cfg, inp = world["cfg"], world["inp"]
    batch = [torch.from_numpy(inp[f"t_{x}"]) for x in ("xy", "mask", "ids")]
    noise = {k[6:]: torch.from_numpy(v) for k, v in inp.items()
             if k.startswith("noise_")}
    new, met = trainer.make_train_step(cfg, 10)(
        create_train_state(cfg, _params(cfg)), *batch, noise=noise)
    return new, met, batch, noise, tree_leaves


def test_data_parallel_step_matches_unsharded(world):
    """tests/test_parallel.py:45: one make_train_step(mesh=(4, 1)) step,
    two rows a rank, from the same state and draws as the unsharded step:
    the same loss and metrics; every rank's params equal to the others',
    bit for bit, and to the unsharded step's up to float32 noise (Adam's
    first update is lr * g / |g|: a gradient within noise of 0 may flip,
    by at most 2 lr, in a few elements)."""
    new, met, *_, tree_leaves = _unsharded_step(world)
    for key, v in met.items():
        got = _all_ranks_equal(world, f"step_{key}")
        np.testing.assert_allclose(got, float(v), err_msg=key, **MESHED_TOL)
    got = _all_ranks_equal(world, "step_params")
    ref = np.concatenate([x.numpy().ravel() for x in tree_leaves(new.params)])
    diff = np.abs(got - ref)
    lr = world["cfg"].learning_rate
    assert diff.max() <= 2 * lr + 1e-5
    assert (diff > 1e-4).mean() <= 1e-3


def test_data_parallel_grads_match_unsharded_tight(world):
    """tests/test_parallel.py:79: the ranks' gradients of the loss with
    global normalisers, summed, against the unsharded gradients."""
    from desire_tpu_torch.train.state import tree_unflatten
    _, _, batch, noise, tree_leaves = _unsharded_step(world)
    cfg = world["cfg"]
    params = _params(cfg)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    total, _ = tdesire.desire_loss(tree_unflatten(params, leaves), cfg,
                                   *batch, step=0, noise=noise)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    ref = torch.cat([(torch.zeros_like(x) if g is None else g).ravel()
                     for g, x in zip(grads, leaves)]).numpy()
    got = _all_ranks_equal(world, "grads")
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _leaf_sizes(cfg):
    from desire_tpu_torch.train.state import tree_leaves
    return [x.numel() for x in tree_leaves(_params(cfg))]


def _check_leaves(got, ref, sizes, rtol):
    """Flat gradients compared leaf by leaf, as tests/test_parallel.py:79
    compares them: rtol, and an atol of rtol times the leaf's peak with a
    floor (tests/test_parallel.py's is 1e-7; here 1e-6). A leaf whose
    gradient is 0 up to float32 noise differs by reduction-order noise
    that means nothing in relative terms: the IOC score head's bias, whose
    gradient under the shift-invariant ranking softmax is a sum of B A K T
    terms that cancel exactly, comes out at ~2e-7 from gradients that are
    summed over the lane blocks (mk times each block's) and ~1e-8
    unsharded."""
    at = np.cumsum([0] + sizes)
    assert got.shape == ref.shape == (at[-1],)
    for i, (a, b) in enumerate(zip(at[:-1], at[1:])):
        atol = max(rtol * float(np.abs(ref[a:b]).max()), 1e-6)
        np.testing.assert_allclose(got[a:b], ref[a:b], rtol=rtol,
                                   atol=atol, err_msg=f"leaf {i}")


@pytest.mark.parametrize("social_freeze", [False, True])
def test_sharded_ioc_training_matches_unsharded(world, social_freeze):
    """ioc_refine_train_sharded on the (2, 2) mesh, its gradients reduced
    as the training step reduces them: the value and every gradient (the
    IOC and message parameters, traj, dec_h, feat_map) against the
    unsharded ioc_refine_train."""
    cfg, inp = world["cfg"], world["inp"]
    got = _all_ranks_equal(world, f"ioc_train_freeze{int(social_freeze)}")
    ref = ioc_train_flat(None, _params(cfg), inp, social_freeze)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-5,
                               atol=1e-5 * np.abs(ref[1:]).max())


def test_sharded_ioc_training_matches_jax(world):
    """tests/test_kernels.py:388: the same value and gradients against
    JAX's make_trainable_fused_ioc_sharded on the (2, 2) CPU mesh
    (interpret mode), rtol = atol = 1e-4."""
    import jax
    import jax.numpy as jnp
    from desire_tpu.ops.ioc_fused import make_trainable_fused_ioc_sharded
    from desire_tpu.parallel import mesh as jmesh
    from desire_tpu_torch.train.state import tree_leaves
    cfg, inp = world["cfg"], world["inp"]
    jp = _jax_tree(_params(cfg))
    fused = make_trainable_fused_ioc_sharded(cfg, jmesh.make_mesh(2, 2),
                                             interpret=True)
    live, fut, wts = (jnp.asarray(inp[f"i_{k}"])
                      for k in ("live", "fut_mask", "wts"))

    def loss(p_ioc, p_scf, traj, dec_h, feat_map):
        refined, scores, iters = fused(p_ioc, p_scf, traj, dec_h, feat_map,
                                       live, fut)
        return (jnp.sum(refined ** 2) + jnp.sum(scores * wts)
                + jnp.sum(iters ** 2))

    v, (g_ioc, g_scf, *g_data) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4)))(
        jp["ioc"], jp["scf"],
        *(jnp.asarray(inp[f"i_{k}"]) for k in ("traj", "dec_h", "feat_map")))
    ref = np.concatenate([np.asarray(v).reshape(1)] + [
        np.asarray(x).ravel() for x in tree_leaves(
            {"ioc": g_ioc, "scf": {"soc_msg": g_scf["soc_msg"],
                                   "soc_logtau": g_scf["soc_logtau"]}})
        + g_data])
    got = _all_ranks_equal(world, "ioc_train_freeze0")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _noise22(world):
    return {k[4:]: torch.from_numpy(v.copy()) for k, v in
            world["inp"].items() if k.startswith("j22_")}


@pytest.mark.parametrize("name", sorted(_LANE_VARIANTS))
def test_lane_parallel_grads_match_unsharded(world, name):
    """desire_loss on the (2, 2) mesh, every rank its rows and its lanes of
    the IOC (the fused trainable IOC, the layer-by-layer ioc_forward, and
    with use_social=False), the gradients reduced as the step reduces
    them, against the unsharded gradients leaf by leaf (1e-4)."""
    cfg, inp = world["cfg"], world["inp"]
    batch = [torch.from_numpy(inp[f"t_{x}"]) for x in ("xy", "mask", "ids")]
    ref = loss_grads_flat(None, small_cfg(**_LANE_VARIANTS[name]),
                          _params(cfg), batch, _noise22(world))
    _check_leaves(_all_ranks_equal(world, f"grads22_{name}"), ref,
                  _leaf_sizes(cfg), rtol=1e-4)


def test_lane_parallel_step_matches_unsharded(world):
    """One make_train_step(mesh=(2, 2)) step against the unsharded step
    from the same state and draws: the loss within 1e-5 relative, every
    metric within the meshed tolerance, the ranks' params bit for bit
    equal, and the unsharded step's up to Adam's sign flips of
    noise-level gradients (test_data_parallel_step_matches_unsharded)."""
    from desire_tpu_torch.train import trainer
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    cfg, inp = world["cfg"], world["inp"]
    batch = [torch.from_numpy(inp[f"t_{x}"]) for x in ("xy", "mask", "ids")]
    new, met = trainer.make_train_step(cfg, 10)(
        create_train_state(cfg, _params(cfg)), *batch, noise=_noise22(world))
    np.testing.assert_allclose(_all_ranks_equal(world, "step22_loss"),
                               float(met["loss"]), rtol=1e-5)
    for key, v in met.items():
        np.testing.assert_allclose(_all_ranks_equal(world, f"step22_{key}"),
                                   float(v), err_msg=key, **MESHED_TOL)
    got = _all_ranks_equal(world, "step22_params")
    diff = np.abs(got - np.concatenate([x.numpy().ravel()
                                        for x in tree_leaves(new.params)]))
    assert diff.max() <= 2 * cfg.learning_rate + 1e-5
    assert (diff > 1e-4).mean() <= 1e-3


def test_lane_parallel_step_matches_jax(world):
    """tests/test_parallel.py:45: the (2, 2) step against JAX's
    make_train_step(mesh=make_mesh(2, 2)) from the same params and state
    key, the JAX draws pinned: every metric within the port's JAX
    tolerance, the params within Adam's lr-sized first step."""
    import jax
    import jax.numpy as jnp
    from desire_tpu.parallel import mesh as jmesh
    from desire_tpu.train import state as jstate
    from desire_tpu.train import trainer as jtrainer
    cfg, inp = world["cfg"], world["inp"]
    jm = jmesh.make_mesh(2, 2)
    sh = jmesh.batch_sharding(jm)
    state = jstate.create_train_state(
        cfg, jax.tree_util.tree_map(jnp.array, _jax_tree(_params(cfg))),
        10, key=jax.random.PRNGKey(12))
    new, met = jtrainer.make_train_step(cfg, 10, mesh=jm)(
        state, *(jax.device_put(jnp.asarray(inp[f"t_{x}"]), sh)
                 for x in ("xy", "mask", "ids")))
    for key, v in met.items():
        np.testing.assert_allclose(_all_ranks_equal(world, f"step22_{key}"),
                                   float(v), err_msg=key, **JAX_SCORE_TOL)
    ref = np.concatenate([np.asarray(x).ravel()
                          for x in jax.tree_util.tree_leaves(new.params)])
    diff = np.abs(_all_ranks_equal(world, "step22_params") - ref)
    assert diff.max() <= 2 * cfg.learning_rate + 1e-5
    assert (diff > 1e-4).mean() <= 1e-3


def test_data_parallel_epoch_matches_jax(world, tmp_path, monkeypatch):
    """run_epoch(mesh=(4, 1)) over the port's loader's rows of 3 batches,
    with the JAX step's draws pinned, against JAX run_epoch over the JAX
    loader from the same params."""
    import jax
    import jax.numpy as jnp
    from desire_tpu.data.loader import SDDLoader as JLoader
    from desire_tpu.train import state as jstate
    from desire_tpu.train import trainer as jtrainer
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "jcache"))
    cfg = small_cfg(data_dir=world["inp"]["tree"].item())
    loader = JLoader(cfg, use_native=False)
    state = jstate.create_train_state(
        cfg, jax.tree_util.tree_map(jnp.array, _jax_tree(_params(cfg))),
        loader.num_batches, key=jax.random.PRNGKey(11))
    ref = []
    jtrainer.run_epoch(state, loader, 0, jtrainer.make_train_step(
        cfg, loader.num_batches), log_every=1, max_batches=_EPOCH_BATCHES,
        log_fn=lambda m, s: ref.append(float(m["loss"])))
    got = _all_ranks_equal(world, "epoch_losses")
    assert len(got) == _EPOCH_BATCHES
    np.testing.assert_allclose(got, ref, rtol=1e-4)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
