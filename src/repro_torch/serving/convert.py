"""Carry weights between the JAX package's parameter tree and the port.

The JAX tree (leaves as numpy arrays, e.g. after ``jax.device_get``) has
``embed``, ``final_norm``, optionally ``unembed``, and the layers as
``groups`` — a list, one dict per layer of the repeating group, each leaf
stacked over the groups on axis 0 — plus ``tail``, a list of per-layer
dicts.  The port's :class:`~repro_torch.models.stack.Transformer` keeps
the same leaf names under ``layers.<i>``, in the same ``[in, out]``
layout, so conversion renames and never transposes.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models.stack import Transformer

_TOP = ("embed", "final_norm", "unembed")


def _flat(tree, prefix="") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def jax_tree_to_state(tree) -> Dict[str, np.ndarray]:
    """Flatten a JAX parameter tree into the port's parameter names."""
    out = {k: np.asarray(tree[k]) for k in _TOP if k in tree}
    period = len(tree["groups"])
    groups = [dict(_flat(g)) for g in tree["groups"]]
    n_groups = len(next(iter(groups[0].values()))) if groups else 0
    for g in range(n_groups):
        for j in range(period):
            for name, leaf in groups[j].items():
                out[f"layers.{g * period + j}.{name}"] = np.asarray(leaf[g])
    for t, layer in enumerate(tree.get("tail", [])):
        for name, leaf in _flat(layer):
            out[f"layers.{n_groups * period + t}.{name}"] = np.asarray(leaf)
    return out


def from_jax_tree(cfg: ModelConfig, tree, dtype=torch.float32,
                  device=None) -> Transformer:
    """A :class:`Transformer` holding the JAX tree's weights, cast to
    ``dtype`` on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    state = jax_tree_to_state(tree)
    model = Transformer(cfg, None, dtype, torch.device("meta"))
    names = {n for n, _ in model.named_parameters()}
    if names != set(state):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(names - set(state))}, unexpected "
                         f"{sorted(set(state) - names)}")
    for name, arr in state.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        t = torch.from_numpy(np.asarray(arr, np.float32).copy())
        setattr(mod, leaf, cm.param(t.to(device=device, dtype=dtype)))
    return model


def to_jax_tree(model: Transformer) -> Dict:
    """The inverse of :func:`from_jax_tree` for a dense stack (group
    period 1): numpy leaves (bf16 weights come back as float32, which
    holds them exactly)."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree: Dict = {k: arr(getattr(model, k)) for k in _TOP
                  if hasattr(model, k)}
    per_layer = [dict((n, arr(p)) for n, p in layer.named_parameters())
                 for layer in model.layers]
    group: Dict = {}
    for name in per_layer[0]:
        node = group
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.stack([lp[name] for lp in per_layer])
    tree["groups"] = [group]
    tree["tail"] = []
    return tree
