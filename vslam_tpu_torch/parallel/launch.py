"""Starting the ranks of a sharded run on one host.

Every rank is its own process, started with the same command plus its
rank; each calls init() to join the process group over TCP on localhost,
then runs the same program (SPMD).  run_ranks() waits for them under one
deadline and kills them all if it passes, so a hung collective fails the
caller instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time

import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank: int, world: int, port: int, backend: str = "gloo",
         timeout_s: float = 60.0) -> None:
    """Join the process group of `world` ranks at tcp://127.0.0.1:port.
    Collectives that wait longer than timeout_s raise."""
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def run_ranks(argv_of_rank, world: int, timeout_s: float, env=None, cwd=None) -> None:
    """Run argv_of_rank(r) for r = 0 .. world-1 at once and wait at most
    timeout_s seconds for all of them; on a timeout or a non-zero exit,
    kill every rank and raise RuntimeError with the rank's output.  Each
    rank writes to a file, not a pipe, so that none can block on a full
    pipe while another waits for it in a collective."""
    env = dict(os.environ if env is None else env)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen(argv_of_rank(r), env=env, cwd=cwd, stdout=log,
                              stderr=subprocess.STDOUT, text=True)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout_s

    def tail(r):
        logs[r].seek(0)
        return logs[r].read()[-3000:]

    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} of {world} still running after {timeout_s} s:\n"
                                   f"{tail(r)}")
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n{tail(r)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
