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
(or the port's own checkpoints), whose keys are already the port's, and
``imagenet_backbone_init`` fills a model from a torchvision ResNet state
dict with ``strict=False`` semantics.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

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


def imagenet_backbone_init(torch_sd: Dict[str, Any], model: torch.nn.Module
                           ) -> Dict[str, List[str]]:
    """Out-of-the-box ImageNet-pretrained initialization (model.py:690-701),
    in place; counterpart of
    ``frn_tpu/convert/torch_import.py::imagenet_backbone_init``.

    The reference's ``model.load_state_dict(torchvision_resnet_sd,
    strict=False)`` (model.py:700): every parameter or buffer of ``model``
    whose name is in ``torch_sd`` is filled. For 'fusion'/'rgb' that is the
    3-channel RGB stem and all four RGB stages (conv1/bn1/layer1..4 match
    torchvision's names), while the event stem and backbone (*_event names),
    the fusion blocks, the FPN and the heads keep their current values.
    Unknown keys (fc.*) are ignored; a present key of another shape raises
    ``ValueError``, as torch does even under strict=False (the 'event'
    variant's 5-channel conv1 therefore cannot take ImageNet weights, as in
    the reference).

    Recipe (given torchvision resnet50 weights at PATH):
        sd = load_reference_checkpoint(PATH)
        model = init_detector(cfg, seed=0, device=...)
        report = imagenet_backbone_init(sd, model)

    Returns the report: 'filled' (names copied, sorted), 'left_at_init' (the
    model's names not in the state dict) and 'ignored' (keys of the state
    dict with no target, e.g. fc.*; BatchNorm's num_batches_tracked is
    neither).
    """
    targets = model.state_dict()
    for name, value in torch_sd.items():
        if name in targets and tuple(np.shape(value)) != tuple(targets[name].shape):
            raise ValueError(f"{name}: shape {tuple(np.shape(value))} != the model's "
                             f"{tuple(targets[name].shape)}")
    filled = sorted(name for name in targets if name in torch_sd)
    with torch.no_grad():
        for name in filled:
            value = torch_sd[name]
            value = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
            targets[name].copy_(value)
    return {
        "filled": filled,
        "left_at_init": [name for name in targets if name not in torch_sd],
        "ignored": [k for k in torch_sd if k not in targets and "num_batches_tracked" not in k],
    }
