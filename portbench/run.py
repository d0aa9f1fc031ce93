"""The benchmark of vtm_torch on one CUDA device:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds (first run in a checkout) or loads the kernel library, makes the
cell's weights and inputs on the device from the seed, warms up the
cell's shapes, measures for ``--seconds``, checks the output against the
plain float32 reference, and prints one JSON line last: with ``--trace
0`` the end-to-end metrics, with ``--trace 1`` the per-layer ones read
from a traced window after the measured one. Exits non-zero, printing no
result, without a CUDA device or if JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench" / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "vtm")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is that of JAX or the JAX package."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.core import driver, program, spec

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"portbench: imports {time.perf_counter() - STARTED:.3f} s", file=sys.stderr)
    built = program.build_kernels()
    print(f"portbench: kernel build {built:.3f} s (0: the checkout's cache held it)", file=sys.stderr)
    line = driver.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, STARTED)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
