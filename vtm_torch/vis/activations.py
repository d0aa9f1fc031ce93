"""Weight and activation extraction and plotting (port of
``vtm/vis/activations.py``).

Functional parity targets:
  slowfast/visualization/utils.py (GetWeightAndActivation:198-293,
    get_indexing:295-316, process_layer_index_data:318-342,
    plot_topk_histogram:132-196, get_layer:365-381)

Layers are named as ``vtm`` names them (flax paths, '/'-separated, a list
entry as ``<list>_<i>``) or by the module's own dotted names
(``gradcam.resolve_layer``). Weights come back in ``vtm``'s layout (a
linear kernel [in, out], a conv kernel [k..., in, out], a norm's scale),
so that their histograms equal ``vtm``'s; activations are collected by
forward hooks, the conv families' 5-D ones made channels-last as ``vtm``'s
are.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from vtm_torch.vis.gradcam import CONV_FAMILIES, resolve_layer


def get_indexing(string: str) -> tuple:
    """Parse numpy-like fancy indexing from a string
    (reference utils.py:295-316): dims separated by ';', indices by ','.
    "1,2;1,2" -> (array([1,2]), array([1,2]))."""
    final_indexing = []
    for index in string.strip().split(";"):
        index_single_dim = index.split(",")
        index_single_dim = [int(i) for i in index_single_dim]
        final_indexing.append(np.array(index_single_dim))
    return tuple(final_indexing)


def process_layer_index_data(layer_ls, layer_name_prefix: str = ""):
    """Split "layer idx" strings into (names, {name: indexing})
    (reference utils.py:318-342)."""
    layer_name, indexing_dict = [], {}
    for layer in layer_ls:
        ls = layer.split()
        name = layer_name_prefix + ls[0]
        layer_name.append(name)
        indexing_dict[name] = get_indexing(ls[1]) if len(ls) == 2 else ()
    return layer_name, indexing_dict


def _vtm_layout(module: nn.Module) -> Optional[torch.Tensor]:
    """A module's weight as ``vtm`` holds it: a linear kernel [in, out], a
    conv kernel [k..., in, out], a norm's scale; a module that only wraps
    one such module (VideoMAE's ``patch_embed``) gives that one's."""
    if isinstance(module, nn.Linear):
        return module.weight.t()
    if isinstance(module, nn.modules.conv._ConvNd):
        w = module.weight
        return w.permute(*range(2, w.ndim), 1, 0)
    weight = getattr(module, "weight", None)
    if isinstance(weight, torch.Tensor):
        return weight
    children = list(module.children())
    return _vtm_layout(children[0]) if len(children) == 1 else None


def get_weights(module: nn.Module, layers: Sequence[str]) -> dict:
    """{layer_name: weight in ``vtm``'s layout} for the named modules or
    parameters (reference GetWeightAndActivation.get_weights:276-293);
    names that name neither, or a module without a weight, are left out."""
    params = dict(module.named_parameters())
    out = {}
    for layer in layers:
        try:
            leaf = _vtm_layout(resolve_layer(module, layer))
        except KeyError:
            *path, last = layer.split("/")
            try:
                parent = resolve_layer(module, "/".join(path)) if path else module
            except KeyError:
                continue
            leaf = params.get(".".join(n for n in (_name_of(module, parent), last) if n))
        if leaf is not None:
            out[layer] = leaf.detach().float().cpu().numpy()
    return out


def _name_of(root: nn.Module, sub: nn.Module) -> str:
    return next(name for name, m in root.named_modules() if m is sub)


def _as_array(value, channels_last: bool) -> np.ndarray:
    if isinstance(value, tuple):
        value = value[0]
    if isinstance(value, list):  # a conv stage's pathways
        return np.asarray([_as_array(v, channels_last) for v in value])
    arr = value.detach().float().cpu().numpy()
    return arr.transpose(0, 2, 3, 4, 1) if channels_last and arr.ndim == 5 else arr


def get_activations(bundle, frames, layers: Sequence[str], bboxes=None, indexing: Optional[dict] = None) -> tuple:
    """One eval-mode forward capturing the named submodules' first outputs
    (reference GetWeightAndActivation.get_activations:251-274); a module's
    (output, extra) pair gives its output. An empty ``layers`` captures
    every submodule, under the module's own names. Returns
    (activation_dict, preds as fp32 numpy)."""
    module = bundle.module
    targets = ({name: resolve_layer(module, name) for name in layers} if layers
               else {name: m for name, m in module.named_modules() if name})
    channels_last = bundle.name in CONV_FAMILIES
    acts = {}

    def recorder(name):
        def hook(_module, _args, out):
            if name not in acts:  # a module run more than once: its first output
                arr = _as_array(out, channels_last)
                idx = (indexing or {}).get(name, ())
                acts[name] = arr[idx] if idx else arr
        return hook

    handles = [m.register_forward_hook(recorder(name)) for name, m in targets.items()]
    device = next(module.parameters()).device
    kwargs = {}
    if bboxes is not None:
        kwargs["bboxes"] = torch.as_tensor(np.asarray(bboxes, np.float32), device=device)
    module.eval()
    try:
        with torch.inference_mode():
            out, _ = module(torch.as_tensor(np.asarray(frames), device=device), **kwargs)
    finally:
        for h in handles:
            h.remove()
    preds = out[0] if isinstance(out, tuple) else out  # EPIC: the verb head
    return acts, preds.float().cpu().numpy()


def plot_topk_histogram(tag: str, array: np.ndarray, k: int = 10, class_names=None, figsize=None):
    """Top-k bar plot as a matplotlib figure (reference utils.py:132-196)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    array = np.asarray(array).reshape(-1)
    ind = np.argsort(-array)[:k]
    val = array[ind]
    fig = plt.Figure(figsize=figsize, facecolor="w", edgecolor="k")
    ax = fig.add_subplot(1, 1, 1)
    names = [str(i) for i in ind] if class_names is None else [class_names[i] for i in ind]
    tick_marks = np.arange(k)
    ax.bar(tick_marks, val, 0.75, color="orange", tick_label=names, edgecolor="w", linewidth=1)
    ax.set_xlabel("Candidates")
    ax.set_xticks(tick_marks)
    ax.set_xticklabels(names, rotation=-45, ha="center")
    ax.xaxis.set_label_position("bottom")
    ax.xaxis.tick_bottom()
    ax.set_yticks(np.linspace(0, 1, num=10))
    ax.set_ylabel(tag)
    fig.set_tight_layout(True)
    return fig
