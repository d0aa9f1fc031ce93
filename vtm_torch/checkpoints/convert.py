"""Checkpoints into the PyTorch package's state-dict layout.

The port names its modules after the upstream layouts (original MCG-NJU
VideoMAE, upstream Motionformer), so an upstream state dict loads as it
is. This module adds:
  * ``load_videomae_state_dict``: original or HuggingFace names (and
    ``module.`` / ``model.`` / ``backbone.`` wrapper prefixes) -> the
    port's names;
  * ``load_motionformer_state_dict``: an upstream Motionformer state dict
    with its wrapper prefixes stripped;
  * ``load_timesformer_state_dict``: original or HuggingFace TimeSformer
    names -> the port's names, with the nearest-neighbour interpolation of
    the position and time embeddings and the image-ViT rule (temporal
    attention cloned from spatial, ``temporal_fc`` zeroed);
  * ``load_vivit_state_dict``: a HuggingFace ``VivitForVideoClassification``
    or reference-wrapper state dict -> the port's names;
  * ``state_dict_from_vtm_params`` / ``motionformer_state_dict_from_vtm_params`` /
    ``timesformer_state_dict_from_vtm_params`` / ``vivit_state_dict_from_vtm_params``:
    the JAX package's param tree (numpy arrays) -> the port's state dict,
    the inverses of ``vtm.checkpoints.convert.convert_videomae`` /
    ``convert_motionformer`` / ``convert_timesformer`` / ``convert_vivit``;
  * ``named_arrays_from_vtm_tree``: any tree shaped like the JAX package's
    VideoMAE params (parameters, gradients, updated parameters) -> numpy
    arrays under the port's parameter names, for name-by-name comparison;
  * ``load_torch_state_dict``: a checkpoint file -> a flat state dict.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a checkpoint file (tensors only, no pickled code) and unwrap
    the ``model_state`` / ``model`` / ``state_dict`` / ``module``
    containers of the reference's checkpoint layouts."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict):
        for key in ("model_state", "model", "state_dict", "module"):
            if key in blob and isinstance(blob[key], dict):
                blob = blob[key]
                break
    return dict(blob)


def strip_prefixes(sd: Mapping[str, object]) -> Dict[str, object]:
    """Remove wrapper prefixes 'module.', 'model.', 'backbone.'; raises
    KeyError when two keys collide after stripping."""
    out: Dict[str, object] = {}
    for k, v in sd.items():
        key = k
        for pre in ("module.", "model.", "backbone."):
            if key.startswith(pre):
                key = key[len(pre):]
        if key in out:
            raise KeyError(f"stripping wrapper prefixes maps {k!r} onto an existing key {key!r}")
        out[key] = v
    return out


def _hf_videomae_to_original(sd: Mapping[str, object]) -> Dict[str, object]:
    """HuggingFace VideoMAEForVideoClassification names -> original
    MCG-NJU names, fusing separate q/k/v back into qkv (copy of
    ``vtm/checkpoints/convert.py::_hf_videomae_to_original``)."""
    out: Dict[str, object] = {}
    layer_re = re.compile(r"^videomae\.encoder\.layer\.(\d+)\.")
    fused: Dict[int, Dict[str, object]] = {}
    for k, v in sd.items():
        if k.startswith("videomae.embeddings.patch_embeddings.projection."):
            out["patch_embed.proj." + k.rsplit(".", 1)[1]] = v
        elif k == "fc_norm.weight":
            out["fc_norm.weight"] = v
        elif k == "fc_norm.bias":
            out["fc_norm.bias"] = v
        elif k == "videomae.layernorm.weight":
            out["norm.weight"] = v
        elif k == "videomae.layernorm.bias":
            out["norm.bias"] = v
        elif k.startswith("classifier."):
            out["head." + k.split(".", 1)[1]] = v
        elif layer_re.match(k):
            i = int(layer_re.match(k).group(1))
            rest = layer_re.sub("", k)
            pre = f"blocks.{i}."
            if rest.endswith("attention.attention.q_bias"):
                out[pre + "attn.q_bias"] = v
            elif rest.endswith("attention.attention.v_bias"):
                out[pre + "attn.v_bias"] = v
            elif rest in (
                "attention.attention.query.weight",
                "attention.attention.key.weight",
                "attention.attention.value.weight",
            ):
                fused.setdefault(i, {})[rest.split(".")[-2]] = v
            elif rest.startswith("attention.output.dense."):
                out[pre + "attn.proj." + rest.rsplit(".", 1)[1]] = v
            elif rest.startswith("intermediate.dense."):
                out[pre + "mlp.fc1." + rest.rsplit(".", 1)[1]] = v
            elif rest.startswith("output.dense."):
                out[pre + "mlp.fc2." + rest.rsplit(".", 1)[1]] = v
            elif rest.startswith("layernorm_before."):
                out[pre + "norm1." + rest.rsplit(".", 1)[1]] = v
            elif rest.startswith("layernorm_after."):
                out[pre + "norm2." + rest.rsplit(".", 1)[1]] = v
    for i, qkv in fused.items():
        out[f"blocks.{i}.attn.qkv.weight"] = torch.cat(
            [_t(qkv["query"]), _t(qkv["key"]), _t(qkv["value"])], dim=0
        )
    return out


def load_videomae_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """Original MCG-NJU or HuggingFace VideoMAE state dict -> the port's
    state dict (torch tensors), ready for ``VideoMAE.load_state_dict``."""
    sd = strip_prefixes(sd)
    if any(k.startswith("videomae.") for k in sd):
        sd = _hf_videomae_to_original(sd)
    return {k: _t(v) for k, v in sd.items()}


def _dense(p, name) -> Dict[str, torch.Tensor]:
    """flax Dense params -> torch Linear entries."""
    out = {f"{name}.weight": _t(np.asarray(p["kernel"]).T.copy())}
    if "bias" in p:
        out[f"{name}.bias"] = _t(np.asarray(p["bias"]))
    return out


def _layernorm(p, name) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(np.asarray(p["scale"])), f"{name}.bias": _t(np.asarray(p["bias"]))}


def _conv3d(p, name) -> Dict[str, torch.Tensor]:
    """flax [kt, kh, kw, C, D] -> torch [D, C, kt, kh, kw]."""
    return {
        f"{name}.weight": _t(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2).copy()),
        f"{name}.bias": _t(np.asarray(p["bias"])),
    }


def _conv2d(p, name) -> Dict[str, torch.Tensor]:
    """flax [kh, kw, C, D] -> torch [D, C, kh, kw]."""
    return {
        f"{name}.weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy()),
        f"{name}.bias": _t(np.asarray(p["bias"])),
    }


def _blocks(params: Mapping):
    """(index, params) of the ``blocks_{i}`` entries, in layer order."""
    return sorted((int(k.split("_")[1]), v) for k, v in params.items() if k.startswith("blocks_"))


def state_dict_from_vtm_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's VideoMAE params (nested dict of arrays) -> the
    port's state dict. Inverse of ``convert_videomae``."""
    sd = _conv3d(params["patch_embed"], "patch_embed.proj")
    for i, blk in _blocks(params):
        pre = f"blocks.{i}"
        sd.update(_layernorm(blk["norm1"], f"{pre}.norm1"))
        sd.update(_layernorm(blk["norm2"], f"{pre}.norm2"))
        sd.update(_dense(blk["attn"]["qkv"], f"{pre}.attn.qkv"))
        sd.update(_dense(blk["attn"]["proj"], f"{pre}.attn.proj"))
        for name in ("q_bias", "v_bias"):
            sd[f"{pre}.attn.{name}"] = _t(np.asarray(blk["attn"][name]))
        sd.update(_dense(blk["mlp"]["fc1"], f"{pre}.mlp.fc1"))
        sd.update(_dense(blk["mlp"]["fc2"], f"{pre}.mlp.fc2"))
    sd.update(_layernorm(params["fc_norm"], "fc_norm"))
    # single head, or the EPIC-KITCHENS twin verb/noun heads
    for name in ("head", "head0", "head1"):
        if name in params:
            sd.update(_dense(params[name], name))
    return sd


def named_arrays_from_vtm_tree(tree: Mapping) -> Dict[str, np.ndarray]:
    """A tree with the structure of the JAX package's VideoMAE params (the
    params themselves, their gradients, or params after an update) as
    numpy arrays under the port's parameter names, with the ``nn.Dense``
    kernels and the tubelet kernel transposed to torch's layouts."""
    return {k: v.numpy() for k, v in state_dict_from_vtm_params(tree).items()}


def load_motionformer_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """Upstream Motionformer state dict -> the port's state dict (torch
    tensors), ready for ``Motionformer.load_state_dict``: the names are
    upstream's (``head`` or the twin ``head0`` / ``head1`` included), so
    only the wrapper prefixes go."""
    return {k: _t(v) for k, v in strip_prefixes(sd).items()}


def motionformer_state_dict_from_vtm_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's Motionformer params (trajectory or joint
    attention) -> the port's state dict. Inverse of
    ``convert_motionformer``. Any tree of that structure goes through
    (gradients, updated parameters), for name-by-name comparison."""
    sd = {
        name: _t(np.asarray(params[name]))
        for name in ("cls_token", "pos_embed", "temp_embed", "st_embed")
        if name in params
    }
    if "patch_embed_3d" in params:
        sd.update(_conv3d(params["patch_embed_3d"], "patch_embed_3d.proj"))
    if "patch_embed" in params:
        sd.update(_conv2d(params["patch_embed"], "patch_embed.proj"))
    for i, blk in _blocks(params):
        pre = f"blocks.{i}"
        sd.update(_layernorm(blk["norm1"], f"{pre}.norm1"))
        sd.update(_layernorm(blk["norm2"], f"{pre}.norm2"))
        for name in ("qkv", "proj_q", "proj_kv", "proj"):
            if name in blk["attn"]:
                sd.update(_dense(blk["attn"][name], f"{pre}.attn.{name}"))
        sd.update(_dense(blk["mlp"]["fc1"], f"{pre}.mlp.fc1"))
        sd.update(_dense(blk["mlp"]["fc2"], f"{pre}.mlp.fc2"))
    sd.update(_layernorm(params["norm"], "norm"))
    if "pre_logits_fc" in params:
        sd.update(_dense(params["pre_logits_fc"], "pre_logits.fc"))
    # single head, or the EPIC-KITCHENS twin verb/noun heads
    for name in ("head", "head0", "head1"):
        if name in params:
            sd.update(_dense(params[name], name))
    return sd


def _interp_tokens_nearest(emb: torch.Tensor, new_len: int) -> torch.Tensor:
    """Nearest-neighbour resize over the token axis of [1, N, D], with
    ``F.interpolate``'s index rule: source = floor(target * N / new_len)."""
    n = emb.shape[1]
    if n == new_len:
        return emb
    idx = torch.from_numpy(np.floor(np.arange(new_len) * n / new_len).astype(np.int64))
    return emb[:, idx, :]


_HF_TIMESFORMER_LAYER = {
    "attention.attention.qkv.": "attn.qkv.",
    "attention.output.dense.": "attn.proj.",
    "temporal_attention.attention.qkv.": "temporal_attn.qkv.",
    "temporal_attention.output.dense.": "temporal_attn.proj.",
    "temporal_dense.": "temporal_fc.",
    "layernorm_before.": "norm1.",
    "temporal_layernorm.": "temporal_norm1.",
    "layernorm_after.": "norm2.",
    "intermediate.dense.": "mlp.fc1.",
    "output.dense.": "mlp.fc2.",
}


def _hf_timesformer_to_original(sd: Mapping[str, object]) -> Dict[str, object]:
    """HuggingFace TimesformerForVideoClassification names -> original
    facebookresearch/TimeSformer names (copy of
    ``vtm/checkpoints/convert.py::_hf_timesformer_to_original``)."""
    out: Dict[str, object] = {}
    layer_re = re.compile(r"^timesformer\.encoder\.layer\.(\d+)\.")
    for k, v in sd.items():
        if k == "timesformer.embeddings.cls_token":
            out["cls_token"] = v
        elif k == "timesformer.embeddings.position_embeddings":
            out["pos_embed"] = v
        elif k == "timesformer.embeddings.time_embeddings":
            out["time_embed"] = v
        elif k.startswith("timesformer.embeddings.patch_embeddings.projection."):
            out["patch_embed.proj." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("timesformer.layernorm."):
            out["norm." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("classifier."):
            out["head." + k.split(".", 1)[1]] = v
        elif layer_re.match(k):
            i = int(layer_re.match(k).group(1))
            rest = layer_re.sub("", k)
            for hf_pre, orig_pre in _HF_TIMESFORMER_LAYER.items():
                if rest.startswith(hf_pre):
                    out[f"blocks.{i}." + orig_pre + rest[len(hf_pre):]] = v
                    break
    return out


def load_timesformer_state_dict(
    sd: Mapping[str, object],
    num_frames: Optional[int] = None,
    spatial_tokens: Optional[int] = None,
    divided: bool = True,
) -> Dict[str, torch.Tensor]:
    """Original TimeSformer or HuggingFace state dict -> the port's state
    dict (torch tensors), ready for ``TimeSformer.load_state_dict``.

    A position embedding of another length than ``spatial_tokens + 1`` and
    a time embedding of another length than ``num_frames`` are resized by
    nearest neighbour (the CLS position kept). Blocks without temporal
    attention (an image ViT) get the image-ViT rule: ``temporal_attn`` and
    ``temporal_norm1`` copy ``attn`` and ``norm1``, ``temporal_fc`` is zero.
    ``divided=False`` (a ``space_only`` or ``joint_space_time`` model, whose
    blocks have no temporal attention) leaves that rule out.
    """
    if any(k.startswith("timesformer.") for k in sd):
        sd = _hf_timesformer_to_original(sd)
    out = {k: _t(v) for k, v in strip_prefixes(sd).items()}
    pos = out["pos_embed"]
    if spatial_tokens is not None and pos.shape[1] != spatial_tokens + 1:
        out["pos_embed"] = torch.cat([pos[:, :1], _interp_tokens_nearest(pos[:, 1:], spatial_tokens)], dim=1)
    if "time_embed" in out and num_frames is not None:
        out["time_embed"] = _interp_tokens_nearest(out["time_embed"], num_frames)
    blocks = sorted({int(m.group(1)) for m in (re.match(r"blocks\.(\d+)\.attn\.qkv\.weight$", k) for k in out) if m})
    for i in blocks if divided else ():
        pre = f"blocks.{i}."
        if pre + "temporal_attn.qkv.weight" in out:
            continue
        for src, dst in (("attn.qkv", "temporal_attn.qkv"), ("attn.proj", "temporal_attn.proj"),
                         ("norm1", "temporal_norm1")):
            for leaf in ("weight", "bias"):
                if f"{pre}{src}.{leaf}" in out:
                    out[f"{pre}{dst}.{leaf}"] = out[f"{pre}{src}.{leaf}"].clone()
        d = out[pre + "attn.proj.weight"].shape[0]
        out[pre + "temporal_fc.weight"] = torch.zeros((d, d), dtype=torch.float32)
        out[pre + "temporal_fc.bias"] = torch.zeros((d,), dtype=torch.float32)
    return out


def timesformer_state_dict_from_vtm_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's TimeSformer params (any attention type) -> the
    port's state dict. Inverse of ``convert_timesformer``. Any tree of that
    structure goes through (gradients, updated parameters), for
    name-by-name comparison."""
    sd = {
        name: _t(np.asarray(params[name]))
        for name in ("cls_token", "pos_embed", "time_embed")
        if name in params
    }
    sd.update(_conv2d(params["patch_embed"], "patch_embed.proj"))
    for i, blk in _blocks(params):
        pre = f"blocks.{i}"
        for name in ("norm1", "norm2", "temporal_norm1"):
            if name in blk:
                sd.update(_layernorm(blk[name], f"{pre}.{name}"))
        for name in ("attn", "temporal_attn"):
            if name in blk:
                sd.update(_dense(blk[name]["qkv"], f"{pre}.{name}.qkv"))
                sd.update(_dense(blk[name]["proj"], f"{pre}.{name}.proj"))
        if "temporal_fc" in blk:
            sd.update(_dense(blk["temporal_fc"], f"{pre}.temporal_fc"))
        sd.update(_dense(blk["mlp"]["fc1"], f"{pre}.mlp.fc1"))
        sd.update(_dense(blk["mlp"]["fc2"], f"{pre}.mlp.fc2"))
    sd.update(_layernorm(params["norm"], "norm"))
    for name in ("head", "head0", "head1"):
        if name in params:
            sd.update(_dense(params[name], name))
    return sd


_HF_VIVIT_LAYER = {
    "layernorm_before.": "layernorm_before.",
    "layernorm_after.": "layernorm_after.",
    "attention.attention.query.": "attention.query.",
    "attention.attention.key.": "attention.key.",
    "attention.attention.value.": "attention.value.",
    "attention.output.dense.": "attention_output.",
    "intermediate.dense.": "intermediate.",
    "output.dense.": "output.",
}
_VIVIT_CLASSIFIERS = ("classifier", "verb_classifier", "noun_classifier")


def load_vivit_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """HuggingFace ``VivitForVideoClassification`` state dict, or the
    reference wrapper's (``vivit.*`` plus ``classifier``, or
    ``verb_classifier`` and ``noun_classifier``) -> the port's state dict
    (torch tensors), ready for ``ViViT.load_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    layer_re = re.compile(r"^vivit\.encoder\.layer\.(\d+)\.")
    for k, v in strip_prefixes(sd).items():
        v = _t(v)
        if k == "vivit.embeddings.cls_token":
            out["cls_token"] = v
        elif k == "vivit.embeddings.position_embeddings":
            out["position_embeddings"] = v
        elif k.startswith("vivit.embeddings.patch_embeddings.projection."):
            out["patch_embed.proj." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("vivit.layernorm."):
            out["layernorm." + k.rsplit(".", 1)[1]] = v
        elif k.split(".", 1)[0] in _VIVIT_CLASSIFIERS:
            out[k] = v
        elif layer_re.match(k):
            i = int(layer_re.match(k).group(1))
            rest = layer_re.sub("", k)
            for hf_pre, own_pre in _HF_VIVIT_LAYER.items():
                if rest.startswith(hf_pre):
                    out[f"layer.{i}." + own_pre + rest[len(hf_pre):]] = v
                    break
    return out


def vivit_state_dict_from_vtm_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ViViT params -> the port's state dict. Inverse of
    ``convert_vivit``. Any tree of that structure goes through (gradients,
    updated parameters), for name-by-name comparison."""
    sd = {name: _t(np.asarray(params[name])) for name in ("cls_token", "position_embeddings")}
    sd.update(_conv3d(params["patch_embed"], "patch_embed.proj"))
    layers = sorted((int(k.split("_")[1]), v) for k, v in params.items() if k.startswith("layer_"))
    for i, blk in layers:
        pre = f"layer.{i}"
        sd.update(_layernorm(blk["layernorm_before"], f"{pre}.layernorm_before"))
        sd.update(_layernorm(blk["layernorm_after"], f"{pre}.layernorm_after"))
        for name in ("query", "key", "value"):
            sd.update(_dense(blk["attention"][name], f"{pre}.attention.{name}"))
        for name in ("attention_output", "intermediate", "output"):
            sd.update(_dense(blk[name], f"{pre}.{name}"))
    sd.update(_layernorm(params["layernorm"], "layernorm"))
    for name in _VIVIT_CLASSIFIERS:
        if name in params:
            sd.update(_dense(params[name], name))
    return sd
