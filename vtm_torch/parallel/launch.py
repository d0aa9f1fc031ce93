"""One process per device (port of the reference's ``launch_job``,
``slowfast/utils/misc.py:402-430``, which ``vtm`` replaced by one process
over a mesh).

``launch_job(cfg, func, devices, backend)`` spawns one process per entry
of ``devices`` (``torch.multiprocessing``, the spawn method), joins each
to one process group (``init_distributed``: a ``file://`` rendezvous in a
fresh temporary directory on one machine, ``INIT_METHOD`` across
``NUM_SHARDS`` machines), calls ``func(cfg, device, *args)`` in each, and
returns what each returned, in rank order (host data: tensors come back on
the CPU). A failure in any rank raises here with that rank's traceback;
``join_timeout`` bounds the whole job.

``run`` is what each entry point's ``main`` does: under torchrun, the
function in this process on ``cuda:LOCAL_RANK``; with one device for the
mesh, the function in this process, as before there was a mesh; else
``launch_job`` over the visible CUDA devices the batch can use
(``mesh_devices``). The backend is ``DIST_BACKEND``'s: "ici" (the default
shared with ``vtm``) and "nccl" mean NCCL, "gloo" gloo. Nothing picks
gloo or the CPU by itself; the tests and ``chip_smoke.py`` name both.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from vtm_torch.parallel.mesh import DEFAULT_TIMEOUT, backend_for, init_distributed, mesh_devices


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _bytes_of(out) -> bytes:
    # plain pickle carries tensors by value; the queue's own pickler would
    # share their memory with a process that is about to exit
    return pickle.dumps(_to_host(out))


def _worker(local_rank, func, cfg, devices, backend, init_method, timeout, num_threads, args, results):
    if num_threads:
        torch.set_num_threads(num_threads)
    device = torch.device(devices[local_rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context exists before the mesh looks for one
    init_distributed(cfg, local_rank=local_rank, local_size=len(devices), backend=backend,
                     init_method=init_method, timeout=timeout)
    try:
        out = func(cfg, device, *args)
        results.put((dist.get_rank(), _bytes_of(out)))
    finally:
        dist.destroy_process_group()


def _drain(results, got: dict) -> None:
    while True:
        try:
            rank, value = results.get_nowait()
        except queue.Empty:
            return
        got[rank] = pickle.loads(value)  # written by this job's own ranks


def launch_job(
    cfg,
    func: Callable,
    devices: Sequence,
    backend: Optional[str] = None,
    args: tuple = (),
    init_method: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
    join_timeout: Optional[float] = None,
    num_threads: Optional[int] = None,
) -> list:
    """``func(cfg, device, *args)`` in one spawned process per entry of
    ``devices`` ("cuda:0", "cpu", ...; an entry may repeat), all in one
    process group of ``backend`` (default: ``DIST_BACKEND``'s) with
    collective timeout ``timeout``. Returns each rank's result in rank
    order. ``func`` must be importable by name (the spawned processes
    import it), and what it returns picklable."""
    devices = [str(d) for d in devices]
    backend = backend or backend_for(cfg.DIST_BACKEND)
    tmp = None
    if init_method is None:
        if cfg.NUM_SHARDS > 1:
            init_method = cfg.INIT_METHOD
        else:
            tmp = tempfile.mkdtemp(prefix="vtm_torch_rendezvous_")
            init_method = "file://" + os.path.join(tmp, "store")
    results = multiprocessing.get_context("spawn").Queue()
    procs = torch.multiprocessing.start_processes(
        _worker,
        args=(func, cfg, devices, backend, init_method, timeout, num_threads, args, results),
        nprocs=len(devices), join=False, start_method="spawn",
    )
    got: dict = {}
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    try:
        while True:
            _drain(results, got)  # before joining: a writer blocks on a full pipe
            if procs.join(timeout=0.5):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"launch_job: {len(devices)} ranks still running after {join_timeout} s")
        wait_until = time.monotonic() + 60
        while len(got) < len(devices) and time.monotonic() < wait_until:
            _drain(results, got)
            time.sleep(0.05)
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if len(got) < len(devices):
        raise RuntimeError(f"launch_job: {len(got)} of {len(devices)} ranks returned a result")
    return [got[r] for r in sorted(got)]


def run(cfg, func: Callable, batch: int, args: tuple = ()) -> list:
    """An entry point's ``main``: ``func(cfg, device, *args)`` over the
    mesh ``batch`` can use (see the module's docstring). Returns the
    results in rank order."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        init_distributed(cfg)
        try:
            return [func(cfg, device, *args)]
        finally:
            dist.destroy_process_group()
    if not torch.cuda.is_available():
        raise RuntimeError("the entry points need a CUDA device and found none")
    devices = mesh_devices([f"cuda:{i}" for i in range(torch.cuda.device_count())], batch,
                           cfg.TPU.MODEL_PARALLEL)
    if len(devices) == 1 and cfg.NUM_SHARDS == 1:
        return [func(cfg, torch.device(devices[0]), *args)]
    return launch_job(cfg, func, devices, args=args)
