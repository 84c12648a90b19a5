"""A cell's ranks on one host, for a traffic mix with "ranks": rank 0 is the
process `run.py` started, on card 0; it starts ranks 1 .. n-1 as child
processes (`rtbench/rank.py`, card r each), with the variables `torchrun`
sets (as `parallel.distributed.launch_local` sets them), steers them over
a gloo group of its own, and guards every rank against one that exits or
stops answering.

Steering: one message a block of steps, sent by rank 0 before the block's
first step (`Team.block`): how many steps, whether to reset the fit first,
and whether the block lies in the traced stretch, which every rank then
profiles alike. Before the stretch opens, at the end of the block before
it, rank 0 arms the others (`Team.arm`): each starts its profiler and all
meet, so that no rank's profiler starts within rank 0's stretch.
`Team.stop` ends the run: each rank sends rank 0 its own reading of the
traced stretch (`Follower.report`, a pair of numbers or None) and exits.

The guard: a NCCL collective inside a replayed graph waits for ever on a
dead peer, so no rank relies on NCCL to notice one. Rank 0's watchdog
thread ends every rank (rank 0 exits 1, before any result line) when a
child exits before it was told to stop, or when rank 0 has made no
progress (`Team.beat`, `Team.block`) for PATIENCE_S, or raises; it kills
the children and waits for their exits before rank 0 exits. A child's
watchdog ends the child when its standard input, a pipe from rank 0,
closes (rank 0 is gone) or when no message has come for PATIENCE_S."""

from __future__ import annotations

import atexit
import datetime
import faulthandler
import os
import re
import select
import signal
import subprocess
import sys
import threading
import time
import traceback

PATIENCE_S = 120.0
# how long a killed child may take to exit (a card's context is torn down)
KILL_WAIT_S = 30.0
# device operations of NCCL: in a fit's traced stretch, the step's
# all-reduce is the only collective on a card
NCCL_KERNEL = re.compile(r"nccl", re.IGNORECASE)
RANK_PY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "rank.py")
_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
             "LOCAL_WORLD_SIZE")
BLOCK, STOP, ARM = 1, 2, 3
REPORT_LEN = 2  # the numbers of a rank's report


def rank_env(rank: int, n: int, port: int) -> dict:
    """The variables `torchrun --nproc_per_node=n` gives rank `rank`."""
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(n), "RANK": str(rank), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(n)}


def _die(text: str) -> None:
    """Print why, every thread's stack, and exit 1 at once."""
    print(f"rtbench: {text}", file=sys.stderr, flush=True)
    faulthandler.dump_traceback(all_threads=True)
    sys.stdout.flush()
    os._exit(1)


def _raised(kind, value, tb) -> None:
    traceback.print_exception(kind, value, tb)
    _die("this rank raised")


class Guard:
    """Rank 0's watchdog over its child processes (see the module's
    docstring). `beat()` marks progress; `stopping()` allows the children
    to exit with 0; `close()` ends the watch."""

    def __init__(self, procs, patience: float = PATIENCE_S):
        self.procs = list(procs)
        self.patience = patience
        self.last = time.monotonic()
        self.exits_allowed = False
        self._done = threading.Event()
        atexit.register(self.kill)
        threading.Thread(target=self._watch, name="rtbench-guard", daemon=True).start()

    def beat(self) -> None:
        self.last = time.monotonic()

    def stopping(self) -> None:
        self.exits_allowed = True
        self.beat()

    def kill(self) -> None:
        """Kill every child still running and wait for each to exit."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(self.procs, start=1):
            try:
                p.wait(timeout=KILL_WAIT_S)
            except subprocess.TimeoutExpired:
                print(f"rtbench: rank {r} (pid {p.pid}) still runs {KILL_WAIT_S:.0f} s "
                      f"after its kill", file=sys.stderr, flush=True)

    def close(self) -> None:
        self._done.set()

    def fail(self, why: str, stacks: bool = False) -> None:
        """End every rank: the children are killed (with `stacks`, asked
        first for their threads' stacks); this process exits 1."""
        self._done.set()
        if stacks:
            for p in self.procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGUSR1)
            time.sleep(1.0)
        self.kill()
        _die(f"{why}; every rank ended, no result")

    def _watch(self) -> None:
        while not self._done.wait(0.2):
            for r, p in enumerate(self.procs, start=1):
                rc = p.poll()
                if rc is not None and (rc != 0 or not self.exits_allowed):
                    self.fail(f"rank {r} exited with {rc}")
            if time.monotonic() - self.last > self.patience:
                self.fail(f"no progress for {self.patience:.0f} s", stacks=True)


class Team:
    """Rank 0's side: the children, their guard and the steering group.
    While it lives, an exception that nothing catches in rank 0 prints its
    traceback and ends every rank (rank 0 exits 1 at once): a rank that
    left would hold the others in a collective, and the interpreter's own
    exit would wait on NCCL."""

    def __init__(self, n: int, argv):
        """Start ranks 1 .. n-1 as `argv` (the arguments of `rank.py`) and
        set rank 0's own variables. The process group is made later, by
        every rank at once (`parallel.distributed.initialize`)."""
        from opencl_ray_tracer_tpu_torch.parallel import distributed

        port = distributed.free_port()
        self.n = n
        self._saved = {k: os.environ.get(k) for k in _ENV_KEYS}
        os.environ.update(rank_env(0, n, port))
        procs = []
        for r in range(1, n):
            env = {**os.environ, **rank_env(r, n, port)}
            # a child writes to rank 0's standard error only: standard
            # output carries the result line alone
            procs.append(subprocess.Popen([sys.executable, RANK_PY, *argv], env=env,
                                          stdin=subprocess.PIPE, stdout=2, stderr=2))
        self.guard = Guard(procs)
        self._hook, sys.excepthook = sys.excepthook, self._raised
        self.group = None

    def _raised(self, kind, value, tb) -> None:
        traceback.print_exception(kind, value, tb)
        self.guard.fail("rank 0 raised")

    def join(self) -> None:
        """The steering group, made by every rank after the default group."""
        self.group = steering_group()
        self.guard.beat()

    def beat(self) -> None:
        self.guard.beat()

    def block(self, steps: int, reset: bool, traced: bool) -> None:
        _send(self.group, BLOCK, steps, reset, traced)
        self.guard.beat()

    def arm(self) -> None:
        """Have every rank start its profiler, and wait until all have: the
        next block is to be traced (a rank drops its profile where the
        stretch does not open there)."""
        _send(self.group, ARM, 0, False, False)
        self.meet()

    def meet(self) -> None:
        """Wait until every rank is here (the steering group's barrier)."""
        import torch.distributed as dist

        dist.barrier(group=self.group)
        self.guard.beat()

    def stop(self, own_report) -> list:
        """Tell the ranks to stop, gather each rank's report (rank 0's is
        `own_report`; a report is a tuple of REPORT_LEN numbers, each may
        be None, or None), end the process group on every rank together, wait
        for the children's exits, and put rank 0's variables back. Returns
        the reports in rank order. Each rank drops its captured steps
        first: NCCL ends a communicator only once no CUDA graph holds it."""
        import torch
        import torch.distributed as dist

        self.guard.stopping()
        _send(self.group, STOP, 0, False, False)
        mine = _report_tensor(own_report)
        parts = [torch.zeros_like(mine) for _ in range(self.n)]
        dist.gather(mine, parts, dst=0, group=self.group)
        dist.destroy_process_group()
        for r, p in enumerate(self.guard.procs, start=1):
            try:
                rc = p.wait(timeout=self.guard.patience)
            except subprocess.TimeoutExpired:
                rc = "nothing: it did not exit after the stop"
            if rc != 0:
                self.guard.fail(f"rank {r} exited with {rc}")
            p.stdin.close()
        self.guard.close()
        sys.excepthook = self._hook
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return [_report_value(t) for t in parts]


class Follower:
    """A child rank's side: its watchdog and the messages from rank 0."""

    def __init__(self):
        self.last = time.monotonic()
        self.group = None
        faulthandler.register(signal.SIGUSR1, all_threads=True)  # rank 0's guard asks
        sys.excepthook = _raised  # exit at once, not through NCCL's teardown
        threading.Thread(target=self._watch, name="rtbench-follow", daemon=True).start()

    def join(self) -> None:
        self.group = steering_group()
        self.beat()

    def beat(self) -> None:
        self.last = time.monotonic()

    def recv(self) -> tuple:
        """(op, steps, reset, traced) of rank 0's next message (op BLOCK,
        ARM or STOP)."""
        import torch
        import torch.distributed as dist

        t = torch.zeros(4, dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.group)
        self.beat()
        op, steps, reset, traced = (int(v) for v in t)
        return op, steps, bool(reset), bool(traced)

    def meet(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)
        self.beat()

    def report(self, value) -> None:
        """Send rank 0 this rank's report (see `Team.stop`), and end the
        process group with every other rank (`Team.stop`)."""
        import torch.distributed as dist

        dist.gather(_report_tensor(value), None, dst=0, group=self.group)
        dist.destroy_process_group()

    def _watch(self) -> None:
        stdin = sys.stdin.buffer
        while True:
            ready, _, _ = select.select([stdin], [], [], 0.5)
            if ready and not stdin.read1(1 << 12):
                _die("rank 0 is gone; this rank exits")
            if time.monotonic() - self.last > PATIENCE_S:
                _die(f"no message from rank 0 for {PATIENCE_S:.0f} s; this rank exits")


def steering_group():
    """A gloo group over every rank (a collective: each rank calls it at the
    same point), whose waits outlast the guard's patience."""
    import torch.distributed as dist

    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=2 * PATIENCE_S))


def _send(group, op, steps, reset, traced) -> None:
    import torch
    import torch.distributed as dist

    dist.broadcast(torch.tensor([op, steps, int(reset), int(traced)],
                                dtype=torch.int64), src=0, group=group)


def _report_tensor(value):
    import torch

    nums = [None] * REPORT_LEN if value is None else list(value)
    return torch.tensor([float("nan") if v is None else float(v) for v in nums],
                        dtype=torch.float64)


def _report_value(t):
    nums = [None if v != v else v for v in (float(x) for x in t)]
    return None if all(v is None for v in nums) else tuple(nums)
