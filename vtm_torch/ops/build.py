"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper into an object, all of
them at once (one nvcc process per source), and the objects are linked
into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -Xptxas -v -c
    nvcc -gencode arch=compute_90a,code=sm_90a -shared

The library lands in ``build/vtm_torch_kernels/`` at the root of the
checkout, named by a hash of the sources (``*.cu`` and the ``*.cuh``
headers they include) and the commands, so a changed source rebuilds and
an unchanged one is reused; beside it, ptxas's report of every kernel's
registers and spills (``kernel_resources``). It is built at first use.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from typing import List, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "vtm_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
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


def report_path() -> pathlib.Path:
    """ptxas's report of the library's build: {source name: its output}."""
    return library_path().with_suffix(".ptxas.json")


def _run_all(cmds: Sequence[List[str]]) -> List[str]:
    """Start every command at once, wait for all; raise RuntimeError on
    the first that fails. Returns each command's stderr."""
    try:
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd in cmds
        ]
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmds[0][0]}): the CUDA kernels cannot be built") from e
    failed, errs = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


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
        reports = _run_all([compile_command(src, obj) for src, obj in zip(sources(), objs)])
        lib = pathlib.Path(tmp) / path.name
        _run_all([link_command(objs, lib)])
        report = pathlib.Path(tmp) / report_path().name
        report.write_text(json.dumps({src.name: r for src, r in zip(sources(), reports)}))
        os.replace(report, report_path())
        os.replace(lib, path)
    return time.perf_counter() - t0


def _template_args(mangled: str) -> tuple:
    """(integers, class names) of the mangled template argument list that
    opens ``mangled`` (``I ... E``): each ``L[ib]<n>E`` literal, and of each
    nested name ``N<len><part>...E`` its last part (a policy such as
    ``vtm::wg::Softmax`` gives "Softmax"). Nothing where no list opens it."""
    ints, names = [], []
    i = 1 if mangled.startswith("I") else len(mangled)
    while i < len(mangled) and mangled[i] != "E":
        literal = re.match(r"L[ib](\d+)E", mangled[i:])
        if literal:
            ints.append(int(literal.group(1)))
            i += literal.end()
            continue
        if mangled[i] != "N":
            break
        i, parts = i + 1, []
        while size := re.match(r"\d+", mangled[i:]):
            i += size.end() + int(size.group())
            parts.append(mangled[i - int(size.group()):i])
        if not parts or mangled[i:i + 1] != "E":
            break
        names.append(parts[-1])
        i += 1
    return ints, names


def parse_ptxas(text: str) -> list:
    """[{kernel, dtype, head_dim, template_args, registers, spill_store_bytes,
    spill_load_bytes}] from ptxas's -v output for one source.
    ``template_args`` holds every integer or bool argument of the instance;
    ``head_dim`` is the first of a first body's (K1-K5's only one). The
    Hopper bodies (``*_wgmma``) are bf16 at head dim 64; their template
    arguments are the compile-time switches (biased; packed), and
    ``policy`` the softmax policy where one is a template argument."""
    rows, entry = [], None
    for line in text.splitlines():
        m = re.search(r"([a-z_]+_kernel)I(f|13__nv_bfloat16)((?:L[ib]\d+E)+)", line)
        wgmma = re.search(r"([a-z_]+_wgmma)", line)
        if m and "Compiling entry function" in line:
            args = [int(x) for x in re.findall(r"L[ib](\d+)E", m.group(3))]
            entry = dict(kernel=m.group(1), dtype="fp32" if m.group(2) == "f" else "bf16", head_dim=args[0],
                         template_args=args)
        elif wgmma and "Compiling entry function" in line:
            args, names = _template_args(line[wgmma.end():])
            entry = dict(kernel=wgmma.group(1), dtype="bf16", head_dim=64, template_args=args)
            if names:
                entry["policy"] = names[-1]
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and entry:
            entry.update(spill_store_bytes=int(spills.group(1)), spill_load_bytes=int(spills.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and entry:
            rows.append(dict(entry, registers=int(regs.group(1))))
            entry = None
    return rows


def kernel_resources(source: str) -> list:
    """``parse_ptxas`` of one source of ``csrc/`` as the library was built
    (building it if needed)."""
    build()
    return parse_ptxas(json.loads(report_path().read_text())[source])


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
        p,              # lse (or null)
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
        p, p,           # out, lse (the forward's residuals)
        p, p, p, p, p,  # dq, dk, dv, dbias, delta
        i, i, i, i,     # batch, num_heads, n, frames
        ctypes.c_float,  # scale
        p,              # strides (26 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_frame_attention_bwd.restype = i
    lib.vtm_blockdiag_attention_fwd.argtypes = [
        i, i,           # dtype, head_dim
        p, p, p, p, p,  # q, k, v, key_bias, out
        p,              # lse (or null)
        i, i, i, i, i,  # batch, num_heads, n, frames, exclude_first_row
        i, i, i,        # the launch plan: frames per block, tiles per frame, blocks
        ctypes.c_float,  # scale
        p,              # strides (12 x int64, host memory)
        p,              # cudaStream_t
    ]
    lib.vtm_blockdiag_attention_fwd.restype = i
    lib.vtm_blockdiag_attention_bwd.argtypes = [
        i, i,           # dtype, head_dim
        p, p, p, p, p,  # q, k, v, key_bias, do
        p, p,           # out, lse (the forward's residuals)
        p, p, p, p, p,  # dq, dk, dv, dbias, delta
        i, i, i, i, i,  # batch, num_heads, n, frames, exclude_first_row
        i, i, i,        # the launch plan: frames per block, tiles per frame, blocks
        ctypes.c_float,  # scale
        p,              # strides (24 x int64, host memory)
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
    lib.vtm_ab_chain_occupancy.argtypes = [i, i, p]  # dtype, variant, out (2 x int, host memory)
    lib.vtm_ab_chain_occupancy.restype = i
    lib.vtm_ab_qk_probe.argtypes = [
        i, i, i,        # dtype, depth, rowsum
        p, p, p,        # q, k, out
        i, i, i,        # groups, nq, nk
        p,              # cudaStream_t
    ]
    lib.vtm_ab_qk_probe.restype = i
    lib.vtm_ab_qk_probe_occupancy.argtypes = [i, i, p]  # depth, rowsum, out (2 x int, host memory)
    lib.vtm_ab_qk_probe_occupancy.restype = i
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
