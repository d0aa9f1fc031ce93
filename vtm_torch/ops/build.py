"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper into an object, all of
them at once (one nvcc process per source), and the objects are linked
into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
    nvcc -gencode arch=compute_90a,code=sm_90a -shared

The library lands in ``build/vtm_torch_kernels/`` at the root of the
checkout, named by a hash of the sources (``*.cu`` and the ``*.cuh``
headers they include) and the commands, so a changed source rebuilds and
an unchanged one is reused. It is built at first use. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import List, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "vtm_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


def sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default
    install location."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        return str(pathlib.Path(cuda_home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def compile_command(src: pathlib.Path, obj: pathlib.Path) -> List[str]:
    return [nvcc_path(), *COMPILE_FLAGS, "-o", str(obj), str(src)]


def link_command(objs: Sequence[pathlib.Path], output: pathlib.Path) -> List[str]:
    return [nvcc_path(), *LINK_FLAGS, "-o", str(output), *(str(o) for o in objs)]


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvtm_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: Sequence[List[str]]) -> None:
    """Start every command at once, wait for all; raise RuntimeError on
    the first that fails."""
    try:
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd in cmds
        ]
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmds[0][0]}): the CUDA kernels cannot be built") from e
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> float:
    """Compile the library unless it exists; returns the seconds nvcc took
    (0.0 when it was already built). Raises RuntimeError on failure."""
    path = library_path()
    if path.exists():
        return 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    # compile into a private directory and rename the library into place:
    # concurrent builds never see a half-written library
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in sources()]
        _run_all([compile_command(src, obj) for src, obj in zip(sources(), objs)])
        lib = pathlib.Path(tmp) / path.name
        _run_all([link_command(objs, lib)])
        os.replace(lib, path)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vtm_attention_fwd.argtypes = [
        i, i,           # dtype, head_dim
        p, p, p, p, p,  # q, k, v, key_bias, out
        p,              # lse (or null)
        i, i, i,        # batch, num_heads, n
        ctypes.c_float,  # scale
        p,              # strides (12 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_attention_fwd.restype = i
    lib.vtm_frame_attention_fwd.argtypes = [
        i, i,           # dtype, head_dim
        p, p, p, p, p,  # q, k, v, key_bias, out
        i, i, i, i,     # batch, num_heads, n, frames
        ctypes.c_float,  # scale
        p,              # strides (13 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_frame_attention_fwd.restype = i
    lib.vtm_attention_bwd.argtypes = [
        i, i,           # dtype, head_dim
        p, p, p, p, p,  # q, k, v, key_bias, do
        p, p,           # out, lse (the forward's residuals)
        p, p, p, p, p,  # dq, dk, dv, dbias, delta
        i, i, i,        # batch, num_heads, n
        ctypes.c_float,  # scale
        p,              # strides (24 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_attention_bwd.restype = i
    lib.vtm_frame_attention_bwd.argtypes = [
        i, i,           # dtype, head_dim
        p, p, p, p, p,  # q, k, v, key_bias, do
        p, p, p, p, p,  # dq, dk, dv, dbias, stats
        i, i, i, i,     # batch, num_heads, n, frames
        ctypes.c_float,  # scale
        p,              # strides (22 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_frame_attention_bwd.restype = i
    lib.vtm_blockdiag_attention_fwd.argtypes = [
        i, i,           # dtype, head_dim
        p, p, p, p, p,  # q, k, v, key_bias, out
        i, i, i, i, i,  # batch, num_heads, n, frames, exclude_first_row
        ctypes.c_float,  # scale
        p,              # strides (12 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_blockdiag_attention_fwd.restype = i
    lib.vtm_blockdiag_attention_bwd.argtypes = [
        i, i,           # dtype, head_dim
        p, p, p, p, p,  # q, k, v, key_bias, do
        p, p, p, p, p,  # dq, dk, dv, dbias, stats
        i, i, i, i, i,  # batch, num_heads, n, frames, exclude_first_row
        ctypes.c_float,  # scale
        p,              # strides (21 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_blockdiag_attention_bwd.restype = i
    lib.vtm_ab_chain.argtypes = [
        i, i,           # dtype, variant
        p, p, p, p, p,  # q, k, v, key_bias, out
        i, i, i,        # batch, num_heads, n
        ctypes.c_float,  # scale
        ctypes.c_longlong,  # bias_batch_stride
        i,              # swap_grid
        p,              # strides (12 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_ab_chain.restype = i
    lib.vtm_ab_qk_probe.argtypes = [
        i, i, i,        # dtype, depth, rowsum
        p, p, p,        # q, k, out
        i, i, i,        # groups, nq, nk
        p,              # cudaStream_t
    ]
    lib.vtm_ab_qk_probe.restype = i
    lib.vtm_ab_dense_variant.argtypes = [
        i, i,           # dtype, variant
        p, p, p, p, p, p, p,  # q, k, v, key_bias, bias_hi, bias_lo, out
        i, i, i,        # batch, num_heads, n
        ctypes.c_float,  # scale
        p,              # strides (12 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_ab_dense_variant.restype = i
    return lib
