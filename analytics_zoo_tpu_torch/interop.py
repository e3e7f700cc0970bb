"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict``s.

A flax tree is given as nested dicts of numpy arrays (``jax.device_get``
of the ``params`` collection, with or without the ``{"params": ...}``
wrapper). The port's modules carry the flax module names as submodule
names, so the mapping is by name, leaf by leaf:

* Dense ``kernel (in, out)``    <-> Linear ``weight (out, in)`` (transposed)
* LayerNorm ``scale`` / ``bias`` <-> ``weight`` / ``bias``
* Dense ``bias``, embedding tables (``embedding``) and free parameters
  such as ``position_embedding`` are copied as they are.

Every conversion is exact (a transpose or a copy), so a round trip
flax -> torch -> flax gives back the same bytes. A missing or an extra key,
or a shape that differs from the module's, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree -> torch ``state_dict`` (CPU tensors)."""
    if set(params) == {"params"}:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(params).items():
        arr = np.asarray(leaf)
        path, _, leaf_name = name.rpartition(".")
        prefix = path + "." if path else ""
        if leaf_name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{name}: only 2-D Dense kernels are "
                                 f"bridged, got shape {arr.shape}")
            sd[prefix + "weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.T))
        elif leaf_name == "scale":
            sd[prefix + "weight"] = torch.from_numpy(arr.copy())
        else:
            sd[name] = torch.from_numpy(arr.copy())
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """torch ``state_dict`` -> flax ``params`` tree of numpy arrays (the
    inverse of :func:`flax_to_state_dict`)."""
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        *path, leaf_name = name.split(".")
        if leaf_name == "weight":
            if arr.ndim == 2:
                leaf_name, arr = "kernel", np.ascontiguousarray(arr.T)
            elif arr.ndim == 1:
                leaf_name = "scale"
            else:
                raise ValueError(f"{name}: unexpected weight rank "
                                 f"{arr.ndim}")
        else:
            arr = arr.copy()
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf_name] = arr
    return tree


def load_flax_params(module: nn.Module, params: Mapping[str, Any]
                     ) -> nn.Module:
    """Copy a flax parameter tree into ``module``. Raises on a missing or
    extra key or a shape mismatch, naming every offender."""
    sd = flax_to_state_dict(params)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    wrong = sorted(f"{k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
                   for k in set(sd) & set(own)
                   if tuple(sd[k].shape) != tuple(own[k].shape))
    if missing or extra or wrong:
        raise ValueError(f"flax params do not fit {type(module).__name__}: "
                         f"missing {missing}, extra {extra}, "
                         f"shape mismatch {wrong}")
    module.load_state_dict(sd, strict=True)
    return module
