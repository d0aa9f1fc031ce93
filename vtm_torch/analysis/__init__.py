from vtm_torch.analysis.splicing import (  # noqa: F401
    KLSimilarityEpickitchens,
    RandomEpickitchens,
    RandomKinetics,
    RandomSsv2,
    SameClassEpickitchens,
    SameClassKinetics,
    SameClassSsv2,
    SplicedDataset,
)
