"""VideoMAE's forward operations a clip, from its configuration and r."""

from __future__ import annotations

from portbench.counts.schedule import merge_products, token_counts


def tokens(m: dict) -> int:
    return (m["img_size"] // m["patch_size"]) ** 2 * (m["num_frames"] // m["tubelet_size"])


def forward_flops(m: dict, r: int) -> int:
    """Products of one clip's forward (2 operations a multiply-add): the
    tubelet embedding, per layer the qkv projection, attention over the
    layer's tokens, the output projection, the merge, and the MLP over the
    merged tokens; then the head."""
    d, depth = m["embed_dim"], m["depth"]
    hidden = int(d * m["mlp_ratio"])
    patch = 3 * m["tubelet_size"] * m["patch_size"] ** 2
    counts = token_counts(tokens(m), r, depth)
    total = 2 * counts[0] * d * patch
    for n, after in zip(counts, counts[1:]):
        total += 2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d
        total += merge_products(n, n - after, d // m["num_heads"], d)
        total += 4 * after * d * hidden
    return total + 2 * d * m["num_classes"]
