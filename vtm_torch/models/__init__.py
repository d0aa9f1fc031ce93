from vtm_torch.models.build import MODEL_CLASSES, MODEL_REGISTRY, ModelBundle, build_model  # noqa: F401
from vtm_torch.models import motionformer, mvit, slowfast, timesformer, videomae, vivit  # noqa: F401  (register their models)
from vtm_torch.models import ptv  # noqa: F401,E402  (after slowfast and mvit: its aliases name their models)
from vtm_torch.models import masked  # noqa: F401,E402
from vtm_torch.models import contrastive  # noqa: F401,E402  (after the backbones it wraps)
