"""Carry the JAX package's model variables into the port.

Input: the variables ``raft_ncup_tpu.models.RAFT.init`` returns, as
nested dicts of numpy arrays (``{'params': ..., 'batch_stats': ...}``;
any mapping works, so flax's FrozenDict does too, and no flax is needed).
Output: a state dict keyed by the reference's torch module tree, which
is the port's (``fnet.layer1.0.conv1.weight``,
``update_block.gru.convz1.bias``, ``update_block.mask.0.weight``,
``upsampler.weights_est_net.conv.0.1.running_mean``,
``upsampler.weights_est_net.up0_conv.conv.1.0.weight``,
``upsampler.interpolation_net.nconv_in.weight_p``, ...). The mapping is
the port's own copy of the one the JAX package's ``utils/torch_export``
applies:

- conv ``kernel`` (HWIO) -> ``weight`` (OIHW); a transposed conv's
  ``kernel`` (kh, kw, out, in) -> ``weight`` (in, out, kh, kw) by the same
  transpose;
- NConv ``weight_p`` (HWIO) -> ``weight_p`` (OIHW), the raw parameter:
  the port maps it through the positivity function at every call;
- norm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
- BatchNorm ``mean`` / ``var`` -> ``running_mean`` / ``running_var``,
  plus the ``num_batches_tracked`` counter torch keeps (zero).

The port holds each tensor once, so the reference's duplicate keys
(the residual blocks' ``norm3`` alias of ``downsample.1``, the NConv
U-Net's ``encoder.*`` aliases) are not produced.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_NORM_WRAPPERS = ("BatchNorm_0", "GroupNorm_0")


def _flatten(tree, prefix=()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _segment(seg: str, in_weights_est: bool) -> list[str]:
    """One flax module name -> the torch module path segments."""
    m = re.fullmatch(r"layer(\d+)_(\d+)", seg)
    if m:
        return [f"layer{m.group(1)}", m.group(2)]
    if seg == "downsample_conv":
        return ["downsample", "0"]
    if seg == "downsample_norm":
        return ["downsample", "1"]
    if seg in ("mask_conv1", "mask_conv2"):
        # The mask head is a Sequential (conv, ReLU, conv).
        return ["mask", "0" if seg == "mask_conv1" else "2"]
    for name in ("nconv_x2", "decoder", "encoder"):
        m = re.fullmatch(rf"{name}_(\d+)", seg)
        if m:
            return [name, m.group(1)]
    if in_weights_est:
        # The weights-estimation net holds (conv, bn) pairs as conv.N.0 /
        # conv.N.1; elsewhere convN stays convN.
        m = re.fullmatch(r"conv(\d+)", seg)
        if m:
            return ["conv", m.group(1), "0"]
        m = re.fullmatch(r"bn(\d+)", seg)
        if m:
            return ["conv", m.group(1), "1"]
    return [seg]


def _module_path(path: tuple) -> str:
    path = tuple(p for p in path if p not in _NORM_WRAPPERS)
    in_we = "weights_est_net" in path
    return ".".join(s for seg in path for s in _segment(seg, in_we))


def _tensor(v) -> torch.Tensor:
    """An f32 tensor owning a contiguous copy of ``v`` (the source may be
    a read-only view of a device buffer)."""
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


def _oihw(v: np.ndarray) -> np.ndarray:
    return v.transpose(3, 2, 0, 1) if v.ndim == 4 else v


def carry_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The port's state dict for JAX ``variables`` of any module subtree
    (the whole RAFT, or e.g. its upsampler's group)."""
    out: dict[str, torch.Tensor] = {}
    for key, val in _flatten(variables.get("params", {})).items():
        *mod, leaf = key
        base = _module_path(tuple(mod))
        val = np.asarray(val, np.float32)
        if leaf in ("kernel", "weight_p"):
            name, val = ("weight" if leaf == "kernel" else leaf), _oihw(val)
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
        out[f"{base}.{name}"] = _tensor(val)
    norms = set()
    for key, val in _flatten(variables.get("batch_stats", {})).items():
        *mod, leaf = key
        base = _module_path(tuple(mod))
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        out[f"{base}.{name}"] = _tensor(val)
        norms.add(base)
    for base in norms:
        out[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def load_jax_variables(module: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load JAX ``variables`` into ``module`` strictly (every key of each
    side must match); returns ``module``."""
    module.load_state_dict(carry_state_dict(variables), strict=True)
    return module
