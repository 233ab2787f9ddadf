"""Hand-written CUDA kernels and their plain PyTorch versions.

Each op dispatches on the device of its tensors: CUDA tensors launch the
kernel (built from ``csrc/`` at first use) with its weights packed into the
layout it reads (``pack_sampler``, ``pack_ioc``; once per param tree where
the caller keeps them), CPU tensors take the plain version. There is no
fallback from one to the other: a kernel that does not build or launch
raises. The training ops (``ioc_refine_train``, ``bivariate_nll_sum``) and
the scene pooling of the layer-by-layer IOC (``bilinear_pool``) are
``torch.autograd.Function``s whose backward is a kernel too. Under a
``(data, k)`` mesh the serving kernels launch per rank on its block
(``sgm_sample_decode_sharded``, ``ioc_refine_sharded``), and so do the
IOC training kernels, their outputs gathered to every lane
(``ioc_refine_train_sharded``). The optimizer's global norm, clip and Adam
over a whole parameter tree are two kernels too (``ops.adam``, called by
``train/state.py``).
"""

from desire_tpu_torch.ops._build import LAUNCHES, reset_launch_counts
from desire_tpu_torch.ops.ioc_bwd import (ioc_refine_train,
                                          ioc_refine_train_sharded)
from desire_tpu_torch.ops.ioc_fused import (ioc_refine, ioc_refine_sharded,
                                            pack_ioc)
from desire_tpu_torch.ops.nll import bivariate_nll_sum
from desire_tpu_torch.ops.scene_pool import bilinear_pool
from desire_tpu_torch.ops.sgm_fused import (pack_sampler, sgm_sample_decode,
                                            sgm_sample_decode_sharded)

__all__ = ["LAUNCHES", "reset_launch_counts", "bilinear_pool",
           "bivariate_nll_sum", "ioc_refine", "ioc_refine_sharded",
           "ioc_refine_train", "ioc_refine_train_sharded", "pack_ioc",
           "pack_sampler", "sgm_sample_decode", "sgm_sample_decode_sharded"]
