"""Pipeline-parallel stage partition of the layer stack.

PyTorch counterpart of ``repro.launch.pipeline``.  JAX slices the scanned
``groups`` axis of its parameter and cache trees; the port keeps one entry
per layer (``Transformer.layers`` and the per-layer cache list), so a
stage is a contiguous run of layers: stage ``s`` owns the layers of its
groups (:func:`repro_torch.models.stack.group_split` gives the same group
count as JAX), stage 0 also owns the embedding, and the last stage owns
the tail layers, the final norm and the unembedding.  The stages are
views of the model's own modules and cache dicts, never copies: at
paper-llama-13b in bf16 the weights alone are 26 GB.

Stage devices default to the visible CUDA cards, one a stage, shared
round-robin when there are fewer cards than stages (placement never
affects results, only overlap).  There is no device mesh: a stage is one
``torch.device``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack


def stage_bounds(n_groups: int, pp: int) -> List[Tuple[int, int]]:
    """Balanced contiguous split of ``n_groups`` groups into ``pp``
    stages: every stage gets >= 1 group (earlier stages take the
    remainder), so layer compute is as uniform per stage as the group
    granularity allows (the paper's §5.3 equal-split assumption)."""
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if pp > max(n_groups, 1):
        raise ValueError(
            f"pp={pp} exceeds the {n_groups} scan group(s) of this stack; "
            f"stage granularity is one group (= one repeating block "
            f"pattern, see repro_torch.models.stack.group_split)")
    base, extra = divmod(n_groups, pp)
    bounds, g = [], 0
    for s in range(pp):
        n = base + (1 if s < extra else 0)
        bounds.append((g, g + n))
        g += n
    return bounds


def _stage_layers(cfg: ModelConfig, pp: int) -> List[List[int]]:
    """The layer indices of each stage: its groups' layers, and on the
    last stage the tail layers."""
    group_kinds, n_groups, tail_kinds = stack.group_split(cfg)
    period = len(group_kinds)
    out = []
    for s, (g0, g1) in enumerate(stage_bounds(n_groups, pp)):
        idx = list(range(g0 * period, g1 * period))
        if s == pp - 1:
            idx += range(n_groups * period,
                         n_groups * period + len(tail_kinds))
        out.append(idx)
    return out


def stage_params(cfg: ModelConfig, params: stack.Transformer,
                 pp: int) -> List[stack.StageParams]:
    """Split a :class:`~repro_torch.models.stack.Transformer` into ``pp``
    :class:`~repro_torch.models.stack.StageParams` views.  Stage 0
    carries ``embed``; the last stage carries ``final_norm`` and the
    unembedding (``embed`` again for tied-embedding models)."""
    out = []
    for s, idx in enumerate(_stage_layers(cfg, pp)):
        kw: Dict = {}
        if s == 0:
            kw["embed"] = params.embed
        if s == pp - 1:
            kw["final_norm"] = params.final_norm
            if cfg.tie_embeddings:
                kw["embed"] = params.embed
            else:
                kw["unembed"] = params.unembed
        out.append(stack.StageParams(
            kinds=tuple(params.kinds[i] for i in idx),
            layers=tuple(params.layers[i] for i in idx), **kw))
    return out


def stage_cache(cfg: ModelConfig, cache: List[Dict],
                pp: int) -> List[List[Dict]]:
    """Split a per-layer cache list (``stack.init_cache``) into per-stage
    lists of the same dicts (the last stage also owns the tail layers'
    cache).  Dense rows and paged pools alike: a pool leaf is per layer
    and goes with its layer."""
    return [[cache[i] for i in idx] for idx in _stage_layers(cfg, pp)]


def stage_devices(pp: int, devices: Optional[Sequence] = None
                  ) -> List[torch.device]:
    """One device per stage: ``devices`` (default: every visible CUDA
    card) in order, shared round-robin when there are fewer than ``pp``
    (results are placement-independent, only stage overlap is lost)."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if not devs:
        raise RuntimeError("no CUDA device for the pipeline stages; pass "
                           "devices= (e.g. ['cpu']) to run elsewhere")
    return [devs[s % len(devs)] for s in range(pp)]


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one: ``cuda`` names the current card."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def _move(t: Optional[torch.Tensor], dev: torch.device):
    return t if t is None or same_device(t.device, dev) else t.to(dev)


def _place(tree, dev: torch.device):
    if isinstance(tree, stack.StageParams):
        for layer in tree.layers:
            if not all(same_device(p.device, dev) for p in layer.parameters()):
                layer.to(dev)
        return stack.StageParams(
            kinds=tree.kinds, layers=tree.layers,
            embed=_move(tree.embed, dev),
            final_norm=_move(tree.final_norm, dev),
            unembed=_move(tree.unembed, dev))
    for layer_cache in tree:
        for part in layer_cache.values():
            for key, leaf in part.items():
                part[key] = _move(leaf, dev)
    return tree


def place_stages(stage_trees: Sequence, devices: Sequence) -> List:
    """Put each stage's params (:func:`stage_params`) or cache
    (:func:`stage_cache`) on its stage device.  Nothing moves for a stage
    that is already there.  Layer modules and cache leaves move in place
    (the model and the cache dicts follow them, so nothing is held
    twice); the embedding, final norm and unembedding are copied onto a
    stage that needs them elsewhere, as JAX's ``device_put`` does."""
    return [_place(tree, torch.device(dev))
            for tree, dev in zip(stage_trees, devices)]
