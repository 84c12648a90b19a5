"""Multi-process bring-up over torch.distributed.

The reference has no distributed story (one process, one device). The JAX
package joins hosts with jax.distributed; here every rank is one process
that owns one card, started by `torchrun` (or by the caller with its own
address, world size and rank), and `initialize` makes the default process
group those processes share: NCCL between cards, gloo only when the caller
asks for the CPU (the tests, the bench's CPU scaling row). A card rank
without NCCL raises; it never falls back to gloo.

A single process needs no group: `initialize()` returns at once when no
coordinator address is given or set, and the mesh then has one rank.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from opencl_ray_tracer_tpu_torch.utils.log import log_info

BACKENDS = ("nccl", "gloo")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Make the default process group of this rank.

    Arguments default from the variables `torchrun` sets: MASTER_ADDR and
    MASTER_PORT ("host:port"), WORLD_SIZE, RANK, and LOCAL_RANK for the card
    (`torch.cuda.set_device` before the group is made). `backend` None or
    "nccl": this rank's card over NCCL; "gloo": the CPU. Returns at once
    without a coordinator address, or when the group already exists."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    backend = backend or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: a card rank needs one "
                               "(ask for the CPU with backend='gloo')")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: card ranks need it")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, **kw)
    log_info("torch.distributed initialized: rank %d/%d over %s", rank, world,
             backend)


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device() -> torch.device:
    """The device of this rank's tensors: the CPU in a gloo group, else this
    rank's card (LOCAL_RANK, or the one `initialize` selected)."""
    if dist.is_initialized():
        if dist.get_backend() == "gloo":
            return torch.device("cpu")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def is_multi_host() -> bool:
    """True when the group spans more ranks than this host runs
    (LOCAL_WORLD_SIZE, as `torchrun` sets it)."""
    n = world_size()
    return n > int(os.environ.get("LOCAL_WORLD_SIZE", n))


def local_row_block(height: int) -> tuple:
    """(row0, rows) owned by this rank under row sharding."""
    n = world_size()
    if height % n:
        raise ValueError(f"height {height} not divisible by {n} ranks")
    rows = height // n
    return rank() * rows, rows


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(n: int, argv: Sequence[str], timeout: float,
                 env: Optional[dict] = None) -> List[subprocess.CompletedProcess]:
    """Run `argv` as n ranks on this host, as `torchrun --nproc_per_node=n`
    would (MASTER_ADDR/MASTER_PORT on a free localhost port, WORLD_SIZE,
    RANK, LOCAL_RANK, LOCAL_WORLD_SIZE), and wait for all of them. Their
    output goes to files, so no rank blocks on a full pipe while another
    waits for it in a collective. Every rank still running `timeout`
    seconds after the start is killed, and then this raises
    subprocess.TimeoutExpired. Returns each rank's completed process."""
    port = free_port()
    deadline = time.monotonic() + timeout
    procs, files = [], []
    try:
        for r in range(n):
            renv = {**os.environ, **(env or {}), "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": str(port), "WORLD_SIZE": str(n),
                    "RANK": str(r), "LOCAL_RANK": str(r),
                    "LOCAL_WORLD_SIZE": str(n)}
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files += [out, err]
            procs.append(subprocess.Popen(list(argv), env=renv, text=True,
                                          stdout=out, stderr=err))
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        done = []
        for p, out, err in zip(procs, files[0::2], files[1::2]):
            out.seek(0)
            err.seek(0)
            done.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                    out.read(), err.read()))
        return done
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
