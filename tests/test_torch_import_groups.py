"""Each module group of the PyTorch package imported alone in a fresh
process pulls in neither jax nor vtm (the groups are
``tests/test_torch_import.py``'s; the whole package at once is tested
there)."""

import subprocess
import sys

import pytest

from test_torch_import import (
    ANALYSIS_MODULES,
    AVA_MODULES,
    CONTRASTIVE_MODULES,
    MASKED_MODULES,
    MVIT_MODULES,
    PTV_MODULES,
    REPO,
    VIS_MODULES,
    _env,
)

FOREIGN = "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'simplejson', 'vtm')"


def _import_alone(*modules: str, unloaded=FOREIGN) -> None:
    code = (f"import sys, {', '.join(modules)}; bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{unloaded}]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ANALYSIS_MODULES + PTV_MODULES + MVIT_MODULES + MASKED_MODULES
                         + CONTRASTIVE_MODULES + AVA_MODULES)
def test_analysis_modules_import_without_jax_alone(module):
    """Each of the new subpackages' modules, and the PTV, multigrid,
    Charades, MViT, masked- and contrastive-pretraining and AVA modules, imported
    alone in a fresh process, pulls in neither jax nor vtm."""
    _import_alone(module)


def test_vis_modules_import_without_jax_together():
    """The visualisation tail, its drivers, the loggers and the pool timer,
    imported together in one fresh process; nor matplotlib, tensorboard,
    pandas or wandb, which they import when a call needs them."""
    _import_alone(*VIS_MODULES, unloaded=FOREIGN[:-1] + ", 'matplotlib', 'tensorboard', 'pandas', 'wandb')")
