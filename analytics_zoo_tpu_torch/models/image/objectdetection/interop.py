"""Weight bridge between the JAX package's flax SSDs and the port's
:class:`~.ssd.SSD` (and its servable, an SSD subclass with the same
state) and :class:`~.ssd.SSDMobileNetV2`.

The port's SSD carries flax's names (``stem``, ``down{i}``,
``loc{size}``, ``conf{size}``, ``BatchNorm_{j}``), and SSDMobileNetV2
its (``backbone`` with the MobileNetV2's ``stem_conv``, ``block{b}_{r}``,
..., then ``extra{i}_conv``/``extra{i}_bn`` and the heads; the depthwise
kernels ``(3, 3, 1, C)`` <-> ``(C, 1, 3, 3)``), so the package-wide
rules of ``analytics_zoo_tpu_torch.interop`` map the two trees leaf by
leaf: conv kernels HWIO <-> OIHW, head biases as they are, BatchNorm
``scale``/``bias`` <-> ``weight``/``bias`` and the ``batch_stats``
``mean``/``var`` <-> ``running_mean``/``running_var``. Every conversion
is a transpose or a copy, so a round trip gives back the same bytes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from torch import nn

from ....interop import (load_flax_params, state_dict_to_batch_stats,
                         state_dict_to_flax)


def load_flax_ssd(module: nn.Module, variables: Mapping[str, Any]
                  ) -> nn.Module:
    """Copy a flax SSD's variables (``{"params", "batch_stats"}``) into
    ``module`` (an SSD, an ``SSDServable`` or an ``SSDMobileNetV2``). Raises on a
    missing or extra key or a shape mismatch."""
    load_flax_params(module, variables)
    return module


def ssd_to_flax(module: nn.Module) -> Dict[str, Any]:
    """The port SSD's state as a flax variables dict ``{"params",
    "batch_stats"}`` of numpy arrays."""
    sd = module.state_dict()
    return {"params": state_dict_to_flax(sd),
            "batch_stats": state_dict_to_batch_stats(sd)}
