"""The training entry point (PyTorch port of the repository's ``train.py``):
the SDD loader's train split, the training steps through the training
kernels, checkpoints with bit-identical resume, evaluation on the
held-out split through the serving kernels, the best checkpoint kept under
``<save_dir>/best`` (and, with ``--final_select_top`` > 1, chosen among a
candidate pool in ``<save_dir>/best_pool`` by a full held-out pass, with
the top-1 rank blend fitted on a train-split slice), JSON-lines metrics in
``<save_dir>/metrics.jsonl``, and recovery from non-finite losses by
rolling back to the last good checkpoint.

    python -m desire_tpu_torch.train --data_dir DATA --save_dir save/ \\
        --num_epochs 5 --batch_size 32            # on the card
    python -m desire_tpu_torch.train --device cpu ...   # on the CPU
    python -m desire_tpu_torch.train --resume 1 --save_dir save/

``--device cuda`` (the default) needs a CUDA device and raises without
one.

Training on a ``(data, k)`` mesh (``--mesh_data md --mesh_k mk``) runs
md * mk processes, one per device, each started with the same flags and
its rank (``parallel/mesh.py``; rank r = d * mk + k on
``cuda:{r % device count}``, NCCL where every rank has a card, gloo on
the CPU or where ranks share one):

    python -m desire_tpu_torch.train --mesh_data 2 --mesh_k 2 \
        --num_processes 4 --coordinator localhost:29500 \
        --process_id 0 ...                                # and 1, 2, 3

Every rank trains on its rows of each batch (block d), and with
mesh_k > 1 refines its block k of the hypothesis lanes through the IOC
training kernels (``train/trainer.py``); only rank 0 logs, writes
checkpoints, evaluates (unsharded, while the others wait) and keeps
best/.
"""

from __future__ import annotations

import argparse
import os
import shutil
import traceback

import torch

from desire_tpu_torch.config import (DesireConfig, add_config_flags,
                                     config_from_args)
from desire_tpu_torch.data.loader import LoaderState, SDDLoader
from desire_tpu_torch.eval.sampler import evaluate, fit_rank_blend
from desire_tpu_torch.models.desire import init_desire
from desire_tpu_torch.parallel import mesh as mesh_mod
from desire_tpu_torch.params import require_device, to_device
from desire_tpu_torch.train import checkpoint as ckpt_mod
from desire_tpu_torch.train import trainer
from desire_tpu_torch.train.state import create_train_state
from desire_tpu_torch.utils import telemetry
from desire_tpu_torch.utils.logging import MetricLogger


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_flags(parser)
    parser.add_argument("--resume", type=int, default=0,
                        help="resume from the latest checkpoint in save_dir")
    parser.add_argument("--max_recoveries", type=int, default=3,
                        help="roll back to the last good checkpoint this "
                             "many times when training hits repeated "
                             "non-finite losses (0 = fail fast)")
    parser.add_argument("--eval_every", type=int, default=1,
                        help="epochs between eval passes (0 = off)")
    parser.add_argument("--max_eval_batches", type=int, default=16)
    parser.add_argument("--final_select_top", type=int, default=3,
                        help="at the end, re-evaluate the best N epochs (by "
                             "the per-epoch eval) on the whole held-out "
                             "split and keep the winner in best/ (0/1 = "
                             "keep the running best)")
    parser.add_argument("--max_train_batches", type=int, default=0,
                        help="cap batches per epoch (0 = all)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler Chrome trace of the "
                             "first (at most 4) batches into this dir "
                             "(rank<r>/ in it, a rank of a mesh)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (needs a CUDA device) or cpu")
    parser.add_argument("--log_every", type=int, default=20,
                        help="batches between logged steps")
    parser.add_argument("--coordinator", type=str, default="",
                        help="multi-process: host:port where rank 0 listens; "
                             "also set --num_processes and --process_id")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--dist_timeout", type=float, default=1800.0,
                        help="seconds a collective waits for the other "
                             "ranks")
    args = parser.parse_args(argv)
    mesh_mod.init_multihost(args.coordinator, args.num_processes,
                            args.process_id, args.device, args.dist_timeout)
    cfg = config_from_args(args)
    train(cfg, resume=bool(args.resume), eval_every=args.eval_every,
          max_eval_batches=args.max_eval_batches,
          max_train_batches=args.max_train_batches or None,
          profile_dir=args.profile_dir or None,
          max_recoveries=args.max_recoveries,
          final_select_top=args.final_select_top, device=args.device,
          log_every=args.log_every, dist_timeout=args.dist_timeout)
    return 0


def _fresh_state(cfg: DesireConfig, device):
    """Step 0: params drawn on the CPU from cfg.seed (the same on every
    device), moved to ``device``; the training generator seeded cfg.seed
    on ``device``."""
    params = init_desire(cfg, torch.Generator().manual_seed(cfg.seed), "cpu")
    return create_train_state(cfg, to_device(params, device))


def train(cfg: DesireConfig, resume: bool = False, eval_every: int = 1,
          max_eval_batches: int = 16, max_train_batches: int | None = None,
          profile_dir: str | None = None, max_recoveries: int = 3,
          final_select_top: int = 3, device="cuda", log_every: int = 20,
          dist_timeout: float = 1800.0):
    """Train cfg.num_epochs epochs on ``device`` and return the final
    state. log_every: batches between logged steps (the finiteness check
    and the mid-epoch checkpoints, every cfg.save_every windows, ride on
    it). With mesh_data * mesh_k > 1 this process is one rank of the
    process group (``parallel.mesh.init_multihost``), on its device of
    ``device``'s type."""
    device = require_device(device)
    mesh = None
    if cfg.mesh_data * cfg.mesh_k > 1:
        mesh = mesh_mod.make_mesh(cfg.mesh_data, cfg.mesh_k, device,
                                  dist_timeout)
        if mesh is None:
            raise ValueError(f"rank {mesh_mod.process_index()} is outside "
                             f"the {cfg.mesh_data}x{cfg.mesh_k} mesh: start "
                             "mesh_data * mesh_k processes")
        device = mesh.device
    is_main = mesh_mod.process_index() == 0
    log = MetricLogger(os.path.join(cfg.save_dir, "metrics.jsonl")
                       if cfg.save_dir and is_main else None,
                       quiet=not is_main)
    try:
        return _train(cfg, log, resume, eval_every, max_eval_batches,
                      max_train_batches, profile_dir, max_recoveries,
                      final_select_top, device, log_every, mesh, is_main)
    finally:
        log.close()


def _train(cfg, log, resume, eval_every, max_eval_batches,
           max_train_batches, profile_dir, max_recoveries, final_select_top,
           device, log_every, mesh, is_main):
    # train/test separation: with holdout='video' training sees only the
    # train split and the periodic eval runs on the held-out videos
    split = "train" if cfg.holdout != "none" else None
    loader = SDDLoader(cfg, split=split)
    log.log({"event": "data", "split": split or "all",
             "videos": len(loader.videos), "windows": loader.num_windows,
             "batches": loader.num_batches, "reader": loader.reader})
    eval_loader, eval_held_out = loader, False
    if cfg.eval_scenes:
        # drop_remainder=False: eval sees every held-out window
        eval_loader = SDDLoader(cfg.replace(scenes=cfg.eval_scenes,
                                            window_hop=cfg.eval_hop),
                                drop_remainder=False)
        eval_held_out = True
    elif cfg.holdout != "none":
        eval_loader = SDDLoader(cfg.replace(window_hop=cfg.eval_hop),
                                split="heldout", drop_remainder=False)
        eval_held_out = True
    if eval_loader is not loader:
        log.log({"event": "eval_data",
                 "videos": [v.name for v in eval_loader.videos],
                 "windows": eval_loader.num_windows})

    state = _fresh_state(cfg, device)
    if cfg.save_dir and not resume:
        # refuse to train fresh into a directory that holds a different
        # run's checkpoints: a colliding step would be skipped and later
        # restore the foreign state. The same config's are the resume case.
        old = ckpt_mod.load_config(cfg.save_dir)
        if old is not None and old != cfg and \
                ckpt_mod.CheckpointManager(cfg.save_dir).latest_step() \
                is not None:
            raise SystemExit(
                f"save_dir {cfg.save_dir} holds checkpoints from a run with "
                "a different config; pass --resume to continue that run, or "
                "use a fresh --save_dir")
    mgr = ckpt_mod.CheckpointManager(cfg.save_dir) if cfg.save_dir else None
    # the best checkpoint by held-out minADE under <save_dir>/best (only
    # where eval runs on a held-out split)
    best_mgr = pool_mgr = None
    best_metric = float("inf")
    if mgr is not None and eval_every and eval_held_out and is_main:
        best_mgr = ckpt_mod.CheckpointManager(
            os.path.join(cfg.save_dir, "best"), keep=1)
        if final_select_top > 1:
            # candidates of the end-of-training selection: the per-epoch
            # eval (max_eval_batches) picks which epochs, a pass over the
            # whole held-out split picks best/ among them
            pool_mgr = ckpt_mod.CheckpointManager(
                os.path.join(cfg.save_dir, "best_pool"),
                keep=final_select_top, keep_best_metric="minADE_px")

    def resume_point(got):
        st, lst = got
        epoch, batch = lst.epoch, lst.batch_index
        if batch >= loader.num_batches:
            epoch, batch = epoch + 1, 0
        return st, epoch, batch

    start_epoch, start_batch = 0, 0
    if resume and mgr is not None:
        got = mgr.restore(state)
        if got is not None:
            state, start_epoch, start_batch = resume_point(got)
            log.log({"event": "resume", "step": int(state.step),
                     "epoch": start_epoch, "batch": start_batch})

    step_fn = trainer.make_train_step(cfg, loader.num_batches, mesh=mesh)
    save_interval = max(cfg.save_every // max(cfg.batch_size, 1), 1)
    recoveries = 0
    epoch = start_epoch
    while epoch < cfg.num_epochs:
        def log_fn(m, cur_state):
            log.log(dict(m, event="train"))
            if mgr is not None and m["batch"] % save_interval == 0 \
                    and m["batch"] > 0:
                mgr.save(cur_state, loader.state, cfg)
        epoch_start = start_batch if epoch == start_epoch else 0
        try:
            if profile_dir and epoch == start_epoch:
                # trace the first few batches; the main loop goes on after
                # them (they took real steps)
                traced = min(max_train_batches or 4, 4)
                with telemetry.profile_trace(
                        profile_dir if mesh is None else os.path.join(
                            profile_dir, "rank%d" % mesh_mod.process_index())
                ) as prof:
                    state, _ = trainer.run_epoch(
                        state, loader, epoch, step_fn, log_fn=log_fn,
                        log_every=log_every, start_batch=epoch_start,
                        max_batches=traced, mesh=mesh)
                # the device's idle seconds by the innermost span open
                log.log({"event": "profile", "dir": profile_dir,
                         "idle_by_span": telemetry.idle_by_span(
                             *telemetry.profile_intervals(prof))})
                epoch_start += traced
            state, mean_loss = trainer.run_epoch(
                state, loader, epoch, step_fn, log_fn=log_fn,
                log_every=log_every, start_batch=epoch_start,
                max_batches=max_train_batches, mesh=mesh)
        except trainer.NonFiniteLossError as e:
            # roll back to the last good checkpoint and go on, at most
            # max_recoveries times, so that a run that always diverges
            # still fails
            recoveries += 1
            if mgr is None or recoveries > max_recoveries:
                raise
            # only rank 0 writes checkpoints: the others restore after it
            # has written its last
            mesh_mod.barrier(mesh)
            got = mgr.restore(_fresh_state(cfg, device))
            if got is None:
                raise
            state, start_epoch, start_batch = resume_point(got)
            log.log({"event": "recover", "error": str(e),
                     "recoveries": recoveries, "step": int(state.step),
                     "epoch": start_epoch, "batch": start_batch})
            epoch = start_epoch
            continue
        log.log({"event": "epoch", "epoch": epoch, "mean_loss": mean_loss})
        if mgr is not None:
            mgr.save(state, loader.state, cfg)
        if eval_every and (epoch + 1) % eval_every == 0 and is_main:
            # rank 0 alone, unsharded (no mesh), while the others wait
            ev = evaluate(state.params, cfg, eval_loader,
                          max_batches=max_eval_batches)
            log.log(dict(ev, event="eval", epoch=epoch,
                         held_out=eval_held_out))
            if best_mgr is not None and ev["minADE_px"] < best_metric:
                best_metric = ev["minADE_px"]
                best_mgr.save(state, loader.state, cfg)
                log.log({"event": "best", "epoch": epoch,
                         "minADE_px": best_metric})
            if pool_mgr is not None:
                pool_mgr.save(state, loader.state, cfg,
                              metrics={"minADE_px": float(ev["minADE_px"])})
        mesh_mod.barrier(mesh)
        epoch += 1
    if pool_mgr is not None:
        _final_best_selection(cfg, pool_mgr, best_mgr, eval_loader, log,
                              device)
    mesh_mod.barrier(mesh)
    return state


def _final_best_selection(cfg, pool_mgr, best_mgr, eval_loader, log,
                          device):
    """Evaluate the candidate epochs on the whole held-out split and
    (re)write best/ with the winner, its config carrying the top-1 rank
    blend fitted on a train-split slice. Every candidate's number is
    logged."""
    steps = pool_mgr.all_steps()
    if not steps:
        return
    template = _fresh_state(cfg, device)
    rows = []
    for s in steps:
        got = pool_mgr.restore_step(s, template)
        if got is None:
            continue
        cand_state, _ = got
        ev = evaluate(cand_state.params, cfg, eval_loader, max_batches=None)
        rows.append((float(ev["minADE_px"]), s, cand_state))
        log.log({"event": "final_select_candidate", "step": s,
                 "minADE_px": float(ev["minADE_px"]),
                 "top1ADE_px": float(ev.get("top1ADE_px", -1.0))})
    if not rows:
        return
    rows.sort(key=lambda r: r[0])
    win_metric, win_step, win_state = rows[0]
    cur = best_mgr.latest_step() if best_mgr is not None else None
    log.log({"event": "final_select", "step": win_step,
             "minADE_px": win_metric, "replaced": cur != win_step,
             "prev_best_step": cur})
    # the top-1 blend, fitted with the winner's params on a train-split
    # slice, goes into the checkpoint's config: eval and serving rank with
    # it by default
    cfg_out = cfg
    try:
        fit_loader = SDDLoader(cfg.replace(window_hop=cfg.eval_hop),
                               split="train", drop_remainder=False)
        bl, diag = fit_rank_blend(win_state.params, cfg, fit_loader)
        cfg_out = cfg.replace(rank_blend_fit=float(bl))
        log.log(dict(diag, event="rank_blend_fit", blend=float(bl)))
    except Exception as e:  # the fit refines the ranking; never fatal
        log.log({"event": "rank_blend_fit", "error": str(e),
                 "traceback": traceback.format_exc()})
    best_dir = os.path.join(cfg.save_dir, "best")
    if cur == win_step:
        # the same checkpoint: only its config gains the fitted blend
        with open(os.path.join(best_dir, "config.json"), "w") as f:
            f.write(cfg_out.to_json())
        return
    # another winner than the running best: best/ anew (a manager skips a
    # step older than its latest)
    shutil.rmtree(best_dir, ignore_errors=True)
    ckpt_mod.CheckpointManager(best_dir, keep=1).save(
        win_state, LoaderState(), cfg_out)
