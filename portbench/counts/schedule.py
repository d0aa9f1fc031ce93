"""ToMe's static token schedule, worked out again from the configuration:
r tokens leave at each layer, at most half of those that may merge."""

from __future__ import annotations

from typing import List


def token_counts(n0: int, r: int, depth: int) -> List[int]:
    """Tokens entering each of ``depth`` layers, then the count left."""
    counts = [n0]
    for _ in range(depth):
        counts.append(counts[-1] - min(r, counts[-1] // 2))
    return counts


def merge_products(n: int, r: int, metric_dim: int, dim: int) -> int:
    """Products of one bipartite merge of ``n`` tokens into ``n - r``: the
    cosine scores of the even against the odd tokens, then the one-hot sums
    of the merged rows and of their sizes into their destinations."""
    if r <= 0:
        return 0
    ta, tb = n - n // 2, n // 2
    return 2 * ta * tb * metric_dim + 2 * tb * r * dim + 2 * tb * r
