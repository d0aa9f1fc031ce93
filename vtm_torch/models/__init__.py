from vtm_torch.models.build import MODEL_REGISTRY, ModelBundle, build_model  # noqa: F401
from vtm_torch.models import motionformer, timesformer, videomae, vivit  # noqa: F401  (register their models)
