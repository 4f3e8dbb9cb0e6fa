"""Weight bridge: the JAX package's flax variables -> this port's state_dict.

The inverse of ``frn_tpu/convert/torch_import.py::convert_state_dict``, written
here so the port imports nothing of the JAX package. ``variables`` is the
``{'params': ..., 'batch_stats': ...}`` tree of nested dicts of arrays (numpy,
or anything ``np.asarray`` takes):

  conv kernel (kh, kw, in, out)  -> weight (out, in, kh, kw)
  conv / BN bias                 -> bias
  BN scale                       -> weight
  batch_stats mean / var         -> running_mean / running_var

Module paths map to the reference's torch names: ``rgb_backbone/layer1_0/...``
-> ``layer1.0...``, ``event_backbone/conv1`` -> ``conv1_event``,
``event_backbone/layer2_1`` -> ``layer2_event.1``, ``downsample_conv`` /
``downsample_bn`` -> ``downsample.0`` / ``downsample.1``, ``fus_0`` ->
``fus.0``; flax's inner ``Conv_0`` level is dropped.

``load_reference_checkpoint`` reads the reference trainer's ``.pth`` files
(or the port's own checkpoints), whose keys are already the port's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _block_path(names, suffix: str) -> str:
    out = []
    for n in names:
        if n.startswith("layer") and "_" in n:
            stage, idx = n[5:].split("_")
            out.append(f"layer{stage}{suffix}.{idx}")
        elif n == "downsample_conv":
            out.append("downsample.0")
        elif n == "downsample_bn":
            out.append("downsample.1")
        else:
            out.append(n)
    return ".".join(out)


def torch_module_name(module_path: Tuple[str, ...]) -> str:
    """Flax module path (no leaf) -> the reference's torch module name."""
    parts = [p for p in module_path if p != "Conv_0"]
    head, rest = parts[0], parts[1:]
    if head in ("rgb_backbone", "backbone"):
        return _block_path(rest, "")
    if head == "event_backbone":
        first, *others = _block_path(rest, "_event").split(".")
        if first in ("conv1", "bn1"):
            first += "_event"
        return ".".join([first] + others)
    if head.startswith("fus_"):
        return f"fus.{head.split('_')[1]}." + ".".join(rest)
    if head in ("fpn", "regressionModel", "classificationModel"):
        return head + "." + ".".join(rest)
    raise KeyError(f"unmapped flax module path: {module_path}")


def torch_key(path: Tuple[str, ...], collection: str) -> str:
    *module, leaf = path
    table = _PARAM_LEAF if collection == "params" else _STATS_LEAF
    return f"{torch_module_name(tuple(module))}.{table[leaf]}"


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables -> {torch name: f32 tensor} for ``FRNDetector.load_state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{path}: expected a 4D conv kernel, got {arr.shape}")
                arr = arr.transpose(3, 2, 0, 1)
            sd[torch_key(path, collection)] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def load_reference_checkpoint(path: str, model: Optional[torch.nn.Module] = None
                              ) -> Dict[str, torch.Tensor]:
    """A reference checkpoint file -> {name: tensor} in the port's names.

    Counterpart of ``frn_tpu/convert/torch_import.py::load_torch_checkpoint``:
    takes a raw state dict or the reference trainer's ``{'model_state_dict',
    'epoch', ...}`` (train_dsec.py:198-200; the port's ``CheckpointManager``
    files have the same key) and strips DataParallel's ``module.`` prefix. The
    reference's BatchNorm ``num_batches_tracked`` counters are dropped: the
    port's batch norm is frozen and keeps no counter. With ``model``, the
    result is loaded into it with ``strict=True``.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if not k.endswith("num_batches_tracked"):
            out[k] = v
    if model is not None:
        model.load_state_dict(out, strict=True)
    return out
