from vtm_torch.merge.bipartite import (  # noqa: F401
    Matching,
    bipartite_soft_matching,
    bipartite_soft_matching_drop,
    bipartite_soft_matching_hybrid,
    drop,
    drop_source,
    kth_bipartite_soft_matching,
    merge,
    merge_source,
    merge_wavg,
    random_bipartite_soft_matching,
    random_scores,
    unmerge,
)
from vtm_torch.merge.policy import MergePolicy, MergeState, reduce_tokens  # noqa: F401
from vtm_torch.merge.schedule import parse_r, token_counts, effective_r  # noqa: F401
