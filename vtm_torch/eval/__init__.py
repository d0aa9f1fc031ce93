from vtm_torch.eval.metrics import (  # noqa: F401
    topks_correct,
    topk_accuracies,
    topk_errors,
    multitask_topk_accuracies,
    multitask_topks_correct,
)
from vtm_torch.eval.meters import TrainMeter, ValMeter  # noqa: F401
