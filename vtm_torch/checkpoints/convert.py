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
  * ``load_pyslowfast_state_dict`` (an upstream PySlowFast ``.pyth`` of
    SlowFast, ResNet or X3D: the upstream names, which the port keeps),
    ``pyslowfast_state_dict_from_vtm`` (the inverse of ``vtm``'s
    ``convert_pyslowfast``: params and BatchNorm statistics),
    ``caffe2_name_to_pytorch`` and ``convert_caffe2`` (Caffe2 blobs);
  * ``load_mvit_state_dict`` (an upstream PySlowFast MViT or reversible
    MViT state dict: the upstream names, which the port keeps, wrapper
    prefixes stripped) and ``mvit_state_dict_from_vtm_params`` (the inverse
    of ``vtm``'s ``convert_mvit``);
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
    state dict (torch tensors), ready for ``VideoMAE.load_state_dict``. The
    layer-scale ``blocks.{i}.gamma_1`` / ``gamma_2`` and the class-pooling
    ``norm`` (HuggingFace's ``videomae.layernorm``) keep their names."""
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
    port's state dict. Inverse of ``convert_videomae``: layer scale's
    ``gamma_1`` / ``gamma_2`` where the blocks have them, and ``fc_norm``
    (mean pooling) or ``norm`` (class pooling), whichever is there."""
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
        for name in ("gamma_1", "gamma_2"):
            if name in blk:
                sd[f"{pre}.{name}"] = _t(np.asarray(blk[name]))
    for name in ("fc_norm", "norm"):
        if name in params:
            sd.update(_layernorm(params[name], name))
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
    """The JAX package's Motionformer params (trajectory, joint or divided
    attention: a divided block's ``timeattn`` and ``norm3`` too) -> the
    port's state dict. Inverse of ``convert_motionformer``. Any tree of
    that structure goes through (gradients, updated parameters), for
    name-by-name comparison."""
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
        if "timeattn" in blk:
            sd.update(_layernorm(blk["norm3"], f"{pre}.norm3"))
            for name in ("qkv", "proj"):
                sd.update(_dense(blk["timeattn"][name], f"{pre}.timeattn.{name}"))
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


def _rename_mlp_heads(sd: Mapping[str, object]) -> Dict[str, object]:
    """Upstream's SSL MLP heads (``head_helper.MLPHead``: a Sequential
    ``projection.{i}`` of Linear, [BatchNorm1d,] ReLU) under the port's names
    (``convnet.MLPHead``: ``fc{k}``, ``bn{k}``): ``head.projection.projection.{i}``
    -> ``head.projection.{fc,bn}{k}``, ``head.predictors.{j}.projection.{i}``
    -> ``head.predictors.{j}.{fc,bn}{k}``; the rule of ``vtm``'s
    ``convert_pyslowfast`` (``rename_mlp``). Other keys as they are."""

    def rename(key: str) -> str:
        m = re.match(r"(.*?(?:projection|predictors\.\d+))\.projection\.(\d+)\.(.*)", key)
        if not m:
            return key
        base, idx, rest = m.group(1), int(m.group(2)), m.group(3)
        bn_on = f"{base}.projection.1.running_mean" in sd
        stride = 3 if bn_on else 2
        if idx % stride == 0:
            return f"{base}.fc{idx // stride}.{rest}"
        if bn_on and idx % stride == 1:
            return f"{base}.bn{(idx + 2) // 3}.{rest}"
        return key  # a ReLU holds nothing

    return {rename(k): v for k, v in sd.items()}


def load_pyslowfast_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """An upstream PySlowFast state dict (SlowFast, ResNet, X3D ``.pyth``)
    -> the port's: the DDP ``module.`` prefix stripped, as ``vtm``'s loader
    strips it, the upstream names kept (the port's modules carry them) but
    for an SSL MLP head's (``_rename_mlp_heads``), and
    ``num_batches_tracked`` dropped (the port's BatchNorm keeps no count).
    Nothing is folded: a SubBatchNorm's ``X.bn`` / ``X.split_bn`` statistics
    keep their names; ``checkpoint.merge_bn_stats`` maps them onto the
    model's BatchNorms."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in _rename_mlp_heads(sd).items():
        key = k[len("module."):] if k.startswith("module.") else k
        if key.endswith("num_batches_tracked"):
            continue
        out[key] = _t(v)
    return out


def pyslowfast_state_dict_from_vtm(params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's conv-family params and ``batch_stats`` (nested
    dicts of arrays) -> the port's state dict: the inverse of
    ``vtm.checkpoints.convert.convert_pyslowfast``. Conv kernels DHWIO ->
    OIDHW, linear kernels transposed, BN ``scale`` -> ``weight``, ``mean`` /
    ``var`` -> ``running_mean`` / ``running_var``; a node with
    ``split_mean`` / ``split_var`` [k, C] is a SubBatchNorm: those become
    ``split_bn.running_*`` [k * C] and its eval statistics
    ``bn.running_*``. Any tree of the params' structure goes through
    (gradients, updated parameters)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(path, leaf, value):
        sd[".".join(path + [leaf])] = _t(value)

    def walk_params(node, path):
        for key, v in node.items():
            if isinstance(v, Mapping):
                walk_params(v, path + [key])
                continue
            a = np.array(v)
            if key == "kernel":
                put(path, "weight", np.ascontiguousarray(a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T))
            else:
                put(path, "weight" if key == "scale" else key, a)

    def walk_stats(node, path):
        if "split_mean" in node:
            for name in ("mean", "var"):
                put(path + ["split_bn"], f"running_{name}", np.array(node[f"split_{name}"]).reshape(-1))
                put(path + ["bn"], f"running_{name}", np.array(node[name]))
            return
        for key, v in node.items():
            if isinstance(v, Mapping):
                walk_stats(v, path + [key])
            elif key in ("mean", "var"):
                put(path, f"running_{key}", np.array(v))

    walk_params(params, [])
    if batch_stats is not None:
        walk_stats(batch_stats, [])
    # vtm's predictor MLPs are siblings ``predictors_{j}``, the port's a list
    return {re.sub(r"(^|\.)predictors_(\d+)\.", r"\1predictors.\2.", k): v for k, v in sd.items()}


# ``vtm``'s CSN and R(2+1)D params and ``batch_stats`` -> the port's state dict
# (``models/ptv.py``): the port's PTV modules carry ``vtm``'s names
# (``stem_conv``, ``s2.res_0.branch2.conv_b_xy``, ``head.projection``), so the
# conv families' structural walk does it, CSN's depthwise kernels [3, 3, 3, 1,
# C] -> [C, 1, 3, 3, 3] and split statistics [k, C] -> ``split_bn.running_*``
# [k * C] included. The other way: ``vtm``'s ``convert_pyslowfast(sd,
# num_splits=k)``.
ptv_state_dict_from_vtm_params = pyslowfast_state_dict_from_vtm


def caffe2_name_to_pytorch(name: str) -> str:
    """A Caffe2 blob name -> the PySlowFast module path: copy of
    ``vtm/checkpoints/convert.py::caffe2_name_to_pytorch`` (the upstream
    regex table, applied in order)."""
    pairs = [
        [r"^nonlocal_conv([0-9]+)_([0-9]+)_(.*)", r"s\1.pathway0_nonlocal\2_\3"],
        [r"^(.*)_nonlocal([0-9]+)_(theta)(.*)", r"\1_nonlocal\2.conv_\3\4"],
        [r"^(.*)_nonlocal([0-9]+)_(g)(.*)", r"\1_nonlocal\2.conv_\3\4"],
        [r"^(.*)_nonlocal([0-9]+)_(phi)(.*)", r"\1_nonlocal\2.conv_\3\4"],
        [r"^(.*)_nonlocal([0-9]+)_(out)(.*)", r"\1_nonlocal\2.conv_\3\4"],
        [r"^(.*)_nonlocal([0-9]+)_(bn)_(.*)", r"\1_nonlocal\2.\3.\4"],
        [r"^t_pool1_subsample_bn_(.*)", r"s1_fuse.bn.\1"],
        [r"^t_pool1_subsample_(.*)", r"s1_fuse.conv_f2s.\1"],
        [r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_bn_(.*)", r"s\1_fuse.bn.\3"],
        [r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_(.*)", r"s\1_fuse.conv_f2s.\3"],
        [r"^res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)", r"s\1.pathway0_res\2.branch\3.\4_\5"],
        [r"^res_conv1_bn_(.*)", r"s1.pathway0_stem.bn.\1"],
        [r"^conv1_xy(.*)", r"s1.pathway0_stem.conv_xy\1"],
        [r"^conv1_(.*)", r"s1.pathway0_stem.conv.\1"],
        [r"^res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)", r"s\1.pathway0_res\2.branch\3_\4"],
        [r"^res_conv1_(.*)", r"s1.pathway0_stem.conv.\1"],
        [r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)", r"s\1.pathway1_res\2.branch\3.\4_\5"],
        [r"^t_res_conv1_bn_(.*)", r"s1.pathway1_stem.bn.\1"],
        [r"^t_conv1_(.*)", r"s1.pathway1_stem.conv.\1"],
        [r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)", r"s\1.pathway1_res\2.branch\3_\4"],
        [r"^t_res_conv1_(.*)", r"s1.pathway1_stem.conv.\1"],
        [r"pred_(.*)", r"head.projection.\1"],
        [r"(.*)b_bn_fc(.*)", r"\1se.fc\2"],
        [r"conv_5(.*)", r"head.conv_5\1"],
        [r"lin_5(.*)", r"head.lin_5\1"],
        [r"(.*)bn.b\Z", r"\1bn.bias"],
        [r"(.*)bn.s\Z", r"\1bn.weight"],
        [r"(.*)bn.rm\Z", r"\1bn.running_mean"],
        [r"(.*)bn.riv\Z", r"\1bn.running_var"],
        [r"(.*)[\._]b\Z", r"\1.bias"],
        [r"(.*)[\._]w\Z", r"\1.weight"],
    ]
    for source, dest in pairs:
        name = re.sub(source, dest, name)
    return name


def convert_caffe2(blobs: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A Caffe2 blob dict -> the port's state dict for the conv families:
    the momentum blobs, ``model_iter`` and ``lr`` skipped, the names
    through ``caffe2_name_to_pytorch``, then ``load_pyslowfast_state_dict``
    (``vtm/checkpoints/convert.py::convert_caffe2``)."""
    sd = {caffe2_name_to_pytorch(k): np.asarray(v) for k, v in blobs.items()
          if "momentum" not in k and k not in ("model_iter", "lr")}
    return load_pyslowfast_state_dict(sd)


def load_mvit_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """An upstream PySlowFast MViT state dict (plain blocks or the
    reversible layout ``rev_backbone.layers.{i}.{F,G,res_proj,pre_q_fuse}``,
    the fusion MLPs ``fuse.fuse_fn.*``) -> the port's: the names are the
    same, so only the wrapper prefixes go (``strip_prefixes``), as
    ``vtm``'s ``convert_mvit`` strips them; an SSL MLP head takes the port's
    names (``_rename_mlp_heads``)."""
    return {k: _t(v) for k, v in _rename_mlp_heads(strip_prefixes(sd)).items()}


# vtm's MViT tree segments -> the port's module path
_MVIT_RENAMES = {"patch_embed": "patch_embed.proj", "head": "head.projection"}


def mvit_state_dict_from_vtm_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's MViT params (nested dicts of arrays) -> the port's
    state dict: the inverse of ``vtm.checkpoints.convert.convert_mvit`` and
    ``_mvit_attn``. ``blocks_{i}`` / ``layers_{i}`` -> ``blocks.{i}`` /
    ``layers.{i}``; ``pool_{q,k,v}_mod`` -> ``pool_{q,k,v}`` (the depthwise
    kernel (kt, kh, kw, 1, C) -> [C, 1, kt, kh, kw]) and ``norm_{q,k,v}``;
    a fusion's ``mlp`` -> ``fuse_fn`` (``fuse_fn.1`` and its ``ln`` ->
    ``fuse_fn.0`` under ``ln+concat_linear``); Dense kernels transposed,
    LayerNorm ``scale`` -> ``weight``; tables as they are; the classifier
    ``head`` -> ``head.projection``, the ROI head's ``head/projection`` ->
    ``head.projection``. Any tree of the params' structure goes through
    (gradients, updated parameters)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + _segment(key, node, path))
                continue
            a = np.array(v)
            if key == "kernel":
                leaf, a = "weight", (a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T)
            else:
                leaf = "weight" if key == "scale" else key
            sd[".".join(path + [leaf])] = _t(np.ascontiguousarray(a))

    def _segment(key, parent, path):
        m = re.fullmatch(r"(blocks|layers)_(\d+)", key)
        if m:
            return [m.group(1), m.group(2)]
        pool = re.fullmatch(r"pool_([qkv])_mod", key)
        if pool:
            return ["<pool>", pool.group(1)]
        if path and path[-1] in ("fuse", "pre_q_fuse"):
            if key == "ln":
                return ["fuse_fn", "0"]
            return ["fuse_fn", "1"] if "ln" in parent else ["fuse_fn"]
        if not path and key == "head" and "projection" in parent[key]:
            return ["head"]  # the ROI head (DETECTION.ENABLE): head/projection -> head.projection
        if not path and key in _MVIT_RENAMES:
            return _MVIT_RENAMES[key].split(".")
        return [key]

    walk(params, [])
    out = {}
    for name, v in sd.items():  # <pool>.q.pool.weight -> pool_q.weight; <pool>.q.norm.* -> norm_q.*
        out[re.sub(r"<pool>\.([qkv])\.(pool|norm)\.", lambda m: f"{m.group(2)}_{m.group(1)}.", name)] = v
    return out


def load_maskmvit_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """An upstream PySlowFast MaskMViT (MaskFeat) or MAE state dict -> the
    port's: the trunk's names and the head's (``pred_head.transforms.{i}.{j}``
    blocks then the norm, ``pred_head.projections.{i}``), ``mask_token``,
    ``decoder_embed``, ``decoder_pos_embed`` and ``dec_pos_embed_*`` are
    the same, so only the wrapper prefixes go, as in ``load_mvit_state_dict``."""
    return load_mvit_state_dict(sd)


def maskmvit_state_dict_from_vtm_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's MaskMViT or MaskMViTMAE params -> the port's state
    dict: the inverse of ``vtm.checkpoints.convert.convert_maskmvit``. The
    trunk goes through ``mvit_state_dict_from_vtm_params``; the head's
    ``transforms_{i}_{j}`` -> ``pred_head.transforms.{i}.{j}``,
    ``transform_norm_{i}`` -> ``pred_head.transforms.{i}.{n_i}`` (after
    head i's n_i blocks), ``projections_{i}`` -> ``pred_head.projections.{i}``."""
    trunk = {k: v for k, v in params.items() if k != "pred_head"}
    sd = mvit_state_dict_from_vtm_params(trunk)
    head = params.get("pred_head", {})
    n_blocks: Dict[str, int] = {}
    for key in head:
        m = re.fullmatch(r"transforms_(\d+)_\d+", key)
        if m:
            n_blocks[m.group(1)] = n_blocks.get(m.group(1), 0) + 1
    for key, node in head.items():
        block = re.fullmatch(r"transforms_(\d+)_(\d+)", key)
        norm = re.fullmatch(r"transform_norm_(\d+)", key)
        proj = re.fullmatch(r"projections_(\d+)", key)
        if block:
            prefix = f"pred_head.transforms.{block.group(1)}.{block.group(2)}"
        elif norm:
            prefix = f"pred_head.transforms.{norm.group(1)}.{n_blocks.get(norm.group(1), 0)}"
        elif proj:
            prefix = f"pred_head.projections.{proj.group(1)}"
        else:
            raise KeyError(f"unknown MaskMViT head entry {key!r}")
        # a node walked as block 0 of a trunk: the block's own names
        for name, v in mvit_state_dict_from_vtm_params({"blocks_0": node}).items():
            sd[prefix + name[len("blocks.0"):]] = v
    return sd


def contrastive_state_dict_from_vtm(params: Mapping, batch_stats: Optional[Mapping], state: Mapping,
                                    proto_params: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """``vtm``'s contrastive training state -> the port's ``ContrastiveModel``
    state dict: the backbone's params and ``batch_stats`` (``all_params["backbone"]``;
    the conv families through ``pyslowfast_state_dict_from_vtm``, MViT, told
    by its ``patch_embed``, through ``mvit_state_dict_from_vtm_params``, its
    MLP head's statistics under ``head.projection``) -> ``backbone.*``;
    ``state["hist_params"]`` / ``["hist_batch_stats"]`` -> ``backbone_hist.*``;
    ``iter``, ``ptr``, ``queue_x``, ``queue_swav``, ``swav_use_the_queue``,
    ``memory`` and ``knn_mem`` -> the buffers of those names; the SwAV
    prototypes' kernel [dim, K] -> ``swav_prototypes.weight`` [K, dim]."""

    def backbone(p, stats):
        if "patch_embed" not in p:
            return pyslowfast_state_dict_from_vtm(p, stats)
        sd = mvit_state_dict_from_vtm_params(p)
        if stats:  # only an MLP head's BatchNorms (CONTRASTIVE.BN_MLP)
            sd.update(pyslowfast_state_dict_from_vtm({}, {"head": {"projection": stats["head"]}}))
        return sd

    sd = {f"backbone.{k}": v for k, v in backbone(params, batch_stats).items()}
    if "hist_params" in state:
        sd.update({f"backbone_hist.{k}": v
                   for k, v in backbone(state["hist_params"], state.get("hist_batch_stats")).items()})
    for name in ("iter", "ptr", "queue_x", "queue_swav", "swav_use_the_queue", "memory", "knn_mem"):
        if name in state:
            a = np.array(state[name])
            sd[name] = _t(a.astype(np.int64) if name in ("iter", "ptr") else a)
    if proto_params is not None:
        sd["swav_prototypes.weight"] = _t(np.ascontiguousarray(np.array(proto_params["kernel"]).T))
    return sd
