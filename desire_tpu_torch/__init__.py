"""desire_tpu_torch: DESIRE trajectory forecasting in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

The port of the ``desire_tpu`` JAX package, module for module. It shares
only ``desire_tpu.config.DesireConfig`` (standard library only) with that
package and never imports JAX. Parameter trees have the same names and
layouts in both packages (``params.from_jax`` / ``params.to_numpy``).

This slice covers the serving path: ``serve.Predictor`` ->
``models.desire.desire_forward(train=False)``, through the fused sampler
(``ops/sgm_fused.py``) and the fused IOC rank-and-refine loop
(``ops/ioc_fused.py``).
"""

from desire_tpu.config import DesireConfig

__version__ = "0.1.0"
__all__ = ["DesireConfig", "__version__"]
