"""Each module group of the PyTorch package imported alone in a process of
its own pulls in neither jax nor vtm (the groups are
``tests/test_torch_import.py``'s; the whole package at once is tested
there). The processes are forked from one fresh interpreter that has
loaded numpy and torch only (``test_torch_import.forked``)."""

import pytest

from test_torch_import import (
    ANALYSIS_MODULES,
    AVA_MODULES,
    CONTRASTIVE_MODULES,
    MASKED_MODULES,
    MVIT_MODULES,
    PTV_MODULES,
    VIS_MODULES,
    forked,
)

FOREIGN = ["jax", "jaxlib", "flax", "optax", "orbax", "simplejson", "vtm"]
ALONE = ANALYSIS_MODULES + PTV_MODULES + MVIT_MODULES + MASKED_MODULES + CONTRASTIVE_MODULES + AVA_MODULES


@pytest.fixture(scope="module")
def imports():
    """Each module of ALONE imported in a process of its own, then the
    visualisation tail's modules together in one more: [exit code, the
    foreign packages loaded] by job."""
    jobs = [["import", [m], FOREIGN] for m in ALONE]
    jobs.append(["import", list(VIS_MODULES), FOREIGN + ["matplotlib", "tensorboard", "pandas", "wandb"]])
    results = forked(jobs)
    return dict(zip(ALONE, results)), results[-1]


@pytest.mark.parametrize("module", ALONE)
def test_analysis_modules_import_without_jax_alone(module, imports):
    """Each of the new subpackages' modules, and the PTV, multigrid,
    Charades, MViT, masked- and contrastive-pretraining and AVA modules, imported
    alone in a process of its own, pulls in neither jax nor vtm."""
    code, message = imports[0][module]
    assert code == 0, message


def test_vis_modules_import_without_jax_together(imports):
    """The visualisation tail, its drivers, the loggers and the pool timer,
    imported together in one process of its own; nor matplotlib,
    tensorboard, pandas or wandb, which they import when a call needs them."""
    code, message = imports[1]
    assert code == 0, message
