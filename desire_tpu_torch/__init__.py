"""desire_tpu_torch: DESIRE trajectory forecasting in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

The port of the ``desire_tpu`` JAX package, module for module. It imports
nothing of that package and never imports JAX: what it needs (the
configuration, ``config.py``) it keeps as its own copy. Parameter trees
have the same names and layouts in both packages (``params.from_jax`` /
``params.to_numpy``).

Ported so far:

* serving: ``serve.Predictor`` -> ``models.desire.desire_forward(train=
  False)``, through the fused sampler (``ops/sgm_fused.py``) and the fused
  IOC rank-and-refine loop (``ops/ioc_fused.py``);
* training: ``train.trainer.make_train_step`` / ``run_epoch`` ->
  ``models.desire.desire_loss`` and Adam (``train/state.py``), through the
  training IOC forward and its backward (``ops/ioc_fused.py``,
  ``ops/ioc_bwd.py``) and the fused bivariate NLL (``ops/nll.py``);
* the training entry point: ``python -m desire_tpu_torch.train``
  (``train/run.py``) over the SDD loader (``data/``), with checkpoints
  (``train/checkpoint.py``), held-out evaluation (``eval/sampler.py``) and
  ``serve.Predictor.from_checkpoint``;
* evaluation and forecasting: ``python -m desire_tpu_torch.evaluate``,
  ``python -m desire_tpu_torch.predict`` (file mode; stream mode through
  ``serve.StreamServer``) and ``python -m desire_tpu_torch.bench_serve``,
  with ``eval/sampler.py``'s ``make_sampler``, ``make_rollout``,
  ``dump_trajectories`` and ``fit_sigma_temperature``; a model's scene
  imagery raster (``scene_image_channels > 0``) reaches every forward.
"""

from desire_tpu_torch.config import DesireConfig

__version__ = "0.1.0"
__all__ = ["DesireConfig", "__version__"]
