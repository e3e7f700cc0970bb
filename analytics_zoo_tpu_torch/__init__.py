"""analytics_zoo_tpu_torch — the PyTorch/CUDA port of analytics_zoo_tpu.

The port mirrors the JAX package's module paths (``ops/attention.py``,
``pipeline/inference/inference_model.py``, ``serving/engine.py``, ...) so
each module's counterpart is found at the same place. Plain tensor code is
PyTorch; every Pallas kernel of the JAX package on a ported path becomes a
hand-written CUDA kernel under ``csrc/``, built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of carrying on on the CPU.

Numerics: TF32 is switched OFF here, for matmuls and for cuDNN, so float32
layers compute in full float32 on the card as they do on the CPU and on the
JAX reference (``jax_default_matmul_precision="highest"``).
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .common.context import (ClusterContext, get_context,  # noqa: E402
                             init_orca_context, stop_orca_context)

__all__ = ["ClusterContext", "init_orca_context", "stop_orca_context",
           "get_context", "__version__"]
