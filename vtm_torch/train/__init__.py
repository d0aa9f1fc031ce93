from vtm_torch.train.losses import get_loss_func, epic_dual_loss  # noqa: F401
from vtm_torch.train.lr_policy import get_lr_at_epoch  # noqa: F401
from vtm_torch.train.optimizer import construct_optimizer, set_lr  # noqa: F401
from vtm_torch.train.train_step import make_train_step, make_eval_step  # noqa: F401
