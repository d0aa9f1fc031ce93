"""The PyTorch package stands alone: it never imports jax, flax, optax,
orbax, simplejson or vtm; chip_smoke.py and the entry points refuse to run
without CUDA; kernels build into an ignored directory, for Hopper. Each
module group imported alone in a fresh process:
``tests/test_torch_import_groups.py``."""

import os
import pathlib
import subprocess
import sys

import pytest

from vtm_torch.ops import build

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vtm_torch
names = [m.name for m in pkgutil.walk_packages(vtm_torch.__path__, "vtm_torch.")]
for name in names:
    importlib.import_module(name)
foreign = ("jax", "jaxlib", "flax", "optax", "orbax", "simplejson", "vtm")
bad = sorted(m for m in sys.modules if m.split(".")[0] in foreign)
assert not bad, bad
print(" ".join(names))
"""

# modules of the training path, each of which must be found and imported
TRAINING_MODULES = (
    "vtm_torch.checkpoints.checkpoint",
    "vtm_torch.data.loader",
    "vtm_torch.data.synthetic",
    "vtm_torch.eval.meters",
    "vtm_torch.eval.metrics",
    "vtm_torch.tools.train_net",
    "vtm_torch.tools.trace_train",
    "vtm_torch.tools.check_frame_bwd",
    "vtm_torch.tools.check_blockdiag",
    "vtm_torch.tools.check_ab",
    "vtm_torch.tools.ab_dense",
    "vtm_torch.ops.ab_attention",
    "vtm_torch.models.timesformer",
    "vtm_torch.models.vivit",
    "vtm_torch.train.losses",
    "vtm_torch.train.lr_policy",
    "vtm_torch.train.mixup",
    "vtm_torch.train.optimizer",
    "vtm_torch.train.train_step",
    "vtm_torch.utils.logging",
    "vtm_torch.utils.timer",
)

# modules of the evaluation path and the real datasets' code
EVAL_MODULES = (
    "vtm_torch.tools.test_net",
    "vtm_torch.tools.run_net",
    "vtm_torch.patch",
    "vtm_torch.data.decoder",
    "vtm_torch.data.transform",
    "vtm_torch.data.rand_augment",
    "vtm_torch.data.kinetics",
    "vtm_torch.data.ssv2",
    "vtm_torch.data.epickitchens",
)

# the PTV families, multigrid and Charades
PTV_MODULES = (
    "vtm_torch.models.ptv",
    "vtm_torch.train.multigrid",
    "vtm_torch.data.charades",
    "vtm_torch.data.ptv",
)

# masked pretraining: the mask generators, MaskFeat and MAE, the MAE visualisation
MASKED_MODULES = (
    "vtm_torch.data.masking",
    "vtm_torch.models.masked",
    "vtm_torch.vis.mae_vis",
)

# contrastive pretraining: the family, its step and its train loop
CONTRASTIVE_MODULES = (
    "vtm_torch.models.contrastive",
    "vtm_torch.train.train_step",
    "vtm_torch.tools.train_net",
)

# AVA detection: the ROI head, the dataset and its transforms, the evaluator
AVA_MODULES = (
    "vtm_torch.models.roi_head",
    "vtm_torch.data.ava",
    "vtm_torch.data.cv2_transform",
    "vtm_torch.data.imagenet",
    "vtm_torch.eval.ava_eval",
    "vtm_torch.utils.pathmgr",
)

# MViT and the reversible MViT
MVIT_MODULES = (
    "vtm_torch.models.mvit",
    "vtm_torch.models.mvit_rev",
)

# the merge visualisation, the analysis tools and the examples
ANALYSIS_MODULES = (
    "vtm_torch.vis",
    "vtm_torch.vis.vis",
    "vtm_torch.analysis",
    "vtm_torch.analysis.splicing",
    "vtm_torch.analysis.dataset_tools",
    "vtm_torch.tools.dataset_utils",
    "vtm_torch.examples",
    "vtm_torch.examples.common",
) + tuple(f"vtm_torch.examples.{name}_example" for name in (
    "videomae", "vivit", "timesformer", "layer_duplication", "clip_splicing"))


# the visualisation and demo tail, its drivers, the loggers and the pool timer
VIS_MODULES = (
    "vtm_torch.utils.class_names",
    "vtm_torch.utils.wandb_utils",
    "vtm_torch.vis.tensorboard_vis",
    "vtm_torch.vis.gradcam",
    "vtm_torch.vis.activations",
    "vtm_torch.vis.video_visualizer",
    "vtm_torch.vis.async_predictor",
    "vtm_torch.vis.demo",
    "vtm_torch.tools.visualization",
    "vtm_torch.tools.demo_net",
    "vtm_torch.tools.ava_demo_precomputed_boxes",
    "vtm_torch.tools.benchmark",
    "vtm_torch.tools.pool_times",
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


# One fresh interpreter loads numpy and torch (what every module of the
# package imports first) and forks a child for each job, so that each job
# runs in a process of its own without paying torch's import again: a job
# ["import", [modules], [packages]] imports the modules and reports any of
# the packages loaded; ["main", module, argv] runs ``python -m module argv``.
# The last line of stdout holds each job's [exit code, message].
_FORKED = """
import importlib, json, os, runpy, sys, traceback
import numpy, torch
jobs = json.loads(sys.argv[1])
results = []
for kind, target, arg in jobs:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        code, message = 0, ""
        try:
            if kind == "import":
                for module in target:
                    importlib.import_module(module)
                bad = sorted(m for m in sys.modules if m.split(".")[0] in arg)
                if bad:
                    code, message = 1, repr(bad)
            else:
                sys.argv = [target, *arg]
                runpy.run_module(target, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
            message = "" if isinstance(e.code, int) or e.code is None else str(e.code)
        except BaseException:
            code, message = 1, traceback.format_exc()
        os.write(w, json.dumps([code, message]).encode())
        os._exit(0)
    os.close(w)
    data = b"".join(iter(lambda: os.read(r, 1 << 16), b""))
    os.close(r)
    os.waitpid(pid, 0)
    results.append(json.loads(data))
print(json.dumps(results))
"""


def forked(jobs: list, env=None) -> list:
    """Each job's [exit code, message] (``_FORKED``), run in one fresh
    interpreter."""
    import json

    proc = subprocess.run([sys.executable, "-c", _FORKED, json.dumps(jobs)], cwd=REPO, env=env or _env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 30
    assert not set(TRAINING_MODULES) - set(names)
    assert not set(EVAL_MODULES) - set(names)
    assert not set(ANALYSIS_MODULES) - set(names)
    assert not set(PTV_MODULES) - set(names)
    assert not set(MVIT_MODULES) - set(names)
    assert not set(MASKED_MODULES) - set(names)
    assert not set(CONTRASTIVE_MODULES) - set(names)
    assert not set(AVA_MODULES) - set(names)
    assert not set(VIS_MODULES) - set(names)


def test_chip_smoke_imports_without_jax():
    code = (
        "import sys, chip_smoke; assert not [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'simplejson', 'vtm')]"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_without_cuda_fails():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# the A/B entry point takes an experiment, not a config
ENTRY_POINT_ARGS = {"vtm_torch.tools.ab_dense": ("--exp", "decomp"), "vtm_torch.tools.check_ab": (),
                    "vtm_torch.tools.check_attention": (), "vtm_torch.tools.kernel_times": (),
                    "vtm_torch.tools.pool_times": ("--exp", "pool")}


ENTRY_POINTS = ["vtm_torch.tools.train_net", "vtm_torch.tools.model_benchmark", "vtm_torch.tools.trace_train",
                "vtm_torch.tools.check_frame_bwd", "vtm_torch.tools.check_blockdiag", "vtm_torch.tools.check_ab",
                "vtm_torch.tools.ab_dense", "vtm_torch.tools.check_attention", "vtm_torch.tools.kernel_times",
                "vtm_torch.tools.test_net", "vtm_torch.tools.run_net", "vtm_torch.tools.visualization",
                "vtm_torch.tools.demo_net", "vtm_torch.tools.ava_demo_precomputed_boxes",
                "vtm_torch.tools.pool_times"] + list(ANALYSIS_MODULES[-5:])


@pytest.fixture(scope="module")
def entry_point_runs():
    """Every entry point run as ``python -m`` without a CUDA device, each in
    a process of its own (``forked``)."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    jobs = [["main", m, list(ENTRY_POINT_ARGS.get(m, ("--opts", "MODEL.MODEL_NAME", "VideoMAE")))]
            for m in ENTRY_POINTS]
    return dict(zip(ENTRY_POINTS, forked(jobs, env)))


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_points_refuse_to_run_without_cuda(module, entry_point_runs):
    """No CUDA device and no request for the CPU: the entry points raise
    instead of carrying on on the CPU."""
    code, message = entry_point_runs[module]
    assert code != 0
    assert "CUDA device" in message


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


_IMPORT_BUILDS_NOTHING = """
import subprocess, ctypes
import numpy, torch  # they load their own libraries
def refuse(*a, **kw):
    raise AssertionError("importing the package started a process or loaded a library")
subprocess.Popen = subprocess.run = ctypes.CDLL = refuse
import importlib, pkgutil
import vtm_torch
for m in pkgutil.walk_packages(vtm_torch.__path__, "vtm_torch."):
    importlib.import_module(m.name)
import chip_smoke
from vtm_torch.ops import flash_attention as fa
assert (fa.LAUNCHES, fa.BWD_LAUNCHES, fa.FRAME_LAUNCHES, fa.FRAME_BWD_LAUNCHES) == (0, 0, 0, 0)
assert (fa.BLOCKDIAG_LAUNCHES, fa.BLOCKDIAG_BWD_LAUNCHES) == (0, 0)
assert set(chip_smoke.COUNTERS) == {n for n in vars(fa) if n.endswith("LAUNCHES")}
from vtm_torch.ops import ab_attention as ab
assert len(ab.AB_LAUNCHES) == 12 and not any(ab.AB_LAUNCHES.values())
"""


def test_importing_builds_and_launches_nothing():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_BUILDS_NOTHING], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr


def test_every_kernel_source_is_built_and_bound():
    """Every kernel source has its C entry point declared in load_library,
    shares the tile header and includes no library's kernels."""
    binding = (REPO / "vtm_torch" / "ops" / "build.py").read_text()
    for src in build.sources():
        text = src.read_text()
        entry = text[text.index('extern "C" int ') + len('extern "C" int '):].split("(")[0]
        assert entry.startswith("vtm_") and f"lib.{entry}.argtypes" in binding, entry
        assert '#include "attention_tiles.cuh"' in text
        includes = [line for line in text.splitlines() if line.startswith("#include")]
        for library in ("cublas", "cudnn", "cutlass", "torch", "ATen"):
            assert not any(library in line for line in includes), (src.name, library)
    assert (build.CSRC / "attention_tiles.cuh").exists()
    names = {src.name for src in build.sources()}
    assert {"blockdiag_attention_fwd.cu", "blockdiag_attention_bwd.cu"} <= names and len(names) >= 6
    assert {"ab_qk_probe.cu", "ab_chain.cu", "ab_dense_variants.cu"} <= names and len(names) == 9


def test_blockdiag_sources_hold_kernels_of_their_own():
    """K5a and K5b are __global__ functions of their own that take the
    frame count and the row mask (each: its first body and its Hopper body);
    neither their sources nor their wrappers call a library's attention, a
    matrix-product routine or K1/K2's entry points."""
    import inspect

    from vtm_torch.ops import flash_attention as fa

    for name, kernels in (("blockdiag_attention_fwd.cu", ["blockdiag_attention_fwd_kernel",
                                                          "blockdiag_attention_fwd_wgmma"]),
                          ("blockdiag_attention_bwd.cu", ["blockdiag_bwd_dq_kernel", "blockdiag_bwd_dkdv_kernel",
                                                          "blockdiag_bwd_dq_wgmma", "blockdiag_bwd_dkdv_wgmma"])):
        text = (build.CSRC / name).read_text()
        assert text.count("__global__") == len(kernels)
        for kernel in kernels:
            assert kernel in text
        assert "exclude_first_row" in text and "frames" in text
        for foreign in ("vtm_attention_fwd", "vtm_attention_bwd", "cublas", "cudnn"):
            assert foreign not in text, (name, foreign)
    for fn in (fa._blockdiag_forward, fa.tome_blockdiag_attention_backward):
        code = inspect.getsource(fn)
        for foreign in ("scaled_dot_product_attention", "matmul", "bmm", "einsum", "torch.compile",
                        "vtm_attention_fwd", "vtm_attention_bwd", "_forward(", "tome_flash_attention"):
            assert foreign not in code.replace("_blockdiag_forward(", ""), (fn.__name__, foreign)


def test_no_module_names_jax_or_vtm():
    """No import of jax, flax, optax or the JAX package anywhere in the
    port's sources or chip_smoke.py."""
    import re

    pattern = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|orbax|vtm)(?:[.\s]|$)", re.M)
    files = list((REPO / "vtm_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_build_targets_sm90a_into_ignored_dir():
    for src in build.sources():
        cmd = build.compile_command(src, build.BUILD_DIR / f"{src.stem}.o")
        assert cmd[1:3] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    link = build.link_command([], build.library_path())
    assert link[1:3] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    rel = build.library_path().relative_to(REPO)
    ignored = [line.strip() for line in (REPO / ".gitignore").read_text().splitlines()]
    assert rel.parts[0] + "/" in ignored
