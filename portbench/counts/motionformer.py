"""Motionformer's forward operations a clip, from its configuration and r.

Tokens: a class token and F = frames / tubelet frames of s = (img /
patch)^2 patches. Each trajectory block attends the class row over every
token, each body query over every body key in F per-frame softmaxes, then
along each token's trajectory: proj_q on the token's own frame, the k half
of proj_kv on all F frames, and the temporal logits and weighted sum (a
product of d a frame each). Merging runs per pseudo-frame, r of s at a
time, between attention and MLP."""

from __future__ import annotations

from portbench.counts.schedule import merge_products, token_counts


def frames(m: dict) -> int:
    return m["num_frames"] // m["patch_size_temp"]


def spatial(m: dict) -> int:
    return (m["img_size"] // m["patch_size"]) ** 2


def forward_flops(m: dict, r: int) -> int:
    d, depth, f = m["embed_dim"], m["depth"], frames(m)
    hidden = int(d * m["mlp_ratio"])
    patch = 3 * m["patch_size_temp"] * m["patch_size"] ** 2
    per_frame = token_counts(spatial(m), r, depth)
    total = 2 * f * per_frame[0] * d * patch
    for s, after in zip(per_frame, per_frame[1:]):
        nb = f * s
        n = nb + 1
        total += 2 * n * d * 3 * d  # qkv
        total += 4 * n * d  # class row over every key
        total += 4 * nb * nb * d  # body rows over every body key, F softmaxes
        total += 2 * nb * d * d + 2 * nb * f * d * d  # proj_q, proj_kv's k half on every frame
        total += 4 * nb * f * d  # temporal logits and weighted sum
        total += 2 * n * d * d  # proj
        total += f * merge_products(s, s - after, d // m["num_heads"], d)
        total += 4 * (1 + f * after) * d * hidden
    head = 2 * d * d if m.get("use_mlp") else 0
    return total + head + 2 * d * m["num_classes"]
