"""Start ranks as processes with the launcher's environment, as torchrun.

``start(cmd, n)`` starts ``n`` copies of a command with torchrun's
variables (``MASTER_ADDR``/``MASTER_PORT`` on a free local port,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and
returns them running (``Ranks``), so that a caller can talk to a rank, a
server say, before waiting; ``run_ranks(cmd, n)`` starts them and waits.
Waiting holds the ranks to ``timeout`` seconds and kills every one of
them when one fails or the time runs out, so a rank that dies or hangs
ends the run with an error naming it.  ``spawn(target, n, args)`` runs
a Python function ``module:function`` on each rank (this module as the
command): it joins the process group (``core.distributed.initialize``),
calls ``function(*args)``, and its return value comes back from every
rank, in rank order, through ``torch.save`` files.

    python -m ladi_vton_tpu_torch.parallel.launch MODULE:FUNCTION ARGS.pt OUT
"""

from __future__ import annotations

import datetime
import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import torch


# the directory that holds the package, so ``python -m`` finds it anywhere
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


class RankFailed(RuntimeError):
    """A rank exited non-zero or did not finish in time."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, n: int, port: int, extra: Optional[dict] = None,
             names: str = "torchrun") -> dict:
    """Rank ``rank``'s environment: torchrun's variables, or with
    ``names="jax"`` the JAX package's ``COORDINATOR_ADDRESS``,
    ``NUM_PROCESSES`` and ``PROCESS_ID`` (and ``LOCAL_RANK``)."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    if names == "jax":
        env.update({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "NUM_PROCESSES": str(n), "PROCESS_ID": str(rank)})
    else:
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": str(n), "RANK": str(rank)})
    env.update({"LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(n)})
    env.update(extra or {})
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


class Ranks:
    """Rank processes as ``start`` leaves them running.

    ``wait()`` blocks until every rank has exited and kills all of them
    when one exits non-zero or the deadline passes; ``close()`` (or
    leaving the ``with`` block) kills whatever still runs.  In between
    the caller may talk to the ranks: ``output(r)`` is rank r's standard
    output so far, ``procs[r]`` its process."""

    def __init__(self, cmd: Sequence[str], n: int, *, timeout: float,
                 env: Optional[dict], cwd, log_dir, names: str,
                 results_dir: Optional[tempfile.TemporaryDirectory] = None):
        self.cmd = list(cmd)
        self._results = results_dir
        self._tmp = (None if log_dir else
                     tempfile.TemporaryDirectory(prefix="ranks_"))
        self.logs = Path(log_dir or self._tmp.name)
        self.logs.mkdir(parents=True, exist_ok=True)
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.procs, self._files = [], []
        port = free_port()
        try:
            for r in range(n):
                out = open(self.logs / f"rank{r}.out", "w")
                err = open(self.logs / f"rank{r}.err", "w")
                self._files.append((out, err))
                self.procs.append(subprocess.Popen(
                    self.cmd, env=rank_env(r, n, port, env, names), cwd=cwd,
                    stdout=out, stderr=err, stdin=subprocess.DEVNULL))
        except BaseException:
            self.close()
            raise

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        for tmp in (self._tmp, self._results):
            if tmp is not None:
                tmp.cleanup()

    def output(self, r: int) -> str:
        return (self.logs / f"rank{r}.out").read_text()

    def _texts(self) -> list:
        return [(self.output(r), (self.logs / f"rank{r}.err").read_text())
                for r in range(len(self.procs))]

    def failure(self) -> Optional[str]:
        """Why the run has failed, if it has: a rank that exited non-zero,
        or ranks still running past the deadline."""
        bad = [r for r, p in enumerate(self.procs)
               if p.poll() not in (None, 0)]
        if bad:
            return f"rank {bad[0]} exited {self.procs[bad[0]].returncode}"
        if any(p.poll() is None for p in self.procs) and \
                time.monotonic() > self.deadline:
            return f"ranks still running after {self.timeout} s"
        return None

    def wait(self) -> list:
        """Each rank's (stdout, stderr) once all have exited 0.  Raises
        ``RankFailed`` (after killing every rank) where one exits non-zero
        or the ranks outlast the deadline."""
        failed = None
        try:
            while failed is None and any(p.poll() is None
                                         for p in self.procs):
                failed = self.failure()
                time.sleep(0.05)
            failed = failed or self.failure()
        finally:
            self.close()
        texts = self._texts()
        if failed:
            tails = "\n".join(f"--- rank {r} stderr ---\n{err[-4000:]}"
                              for r, (_, err) in enumerate(texts))
            raise RankFailed(f"{' '.join(self.cmd[:4])}: {failed}\n{tails}")
        return texts

    def results(self) -> list:
        """``wait()``, then the return value of each rank's function, in
        rank order (ranks that ``spawn`` started)."""
        self.wait()
        return [torch.load(Path(self._results.name) / f"result{r}.pt",
                           weights_only=False)
                for r in range(len(self.procs))]

    def close(self) -> None:
        """Kill the ranks still running and release their files."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        for out, err in self._files:
            out.close()
            err.close()
        self._files = []


def start(cmd: Sequence[str], n: int, *, timeout: float,
          env: Optional[dict] = None, cwd=None, log_dir=None,
          names: str = "torchrun") -> Ranks:
    """Start ``cmd`` as ranks 0..n-1 and return at once; the ranks must
    all have exited within ``timeout`` seconds (``Ranks.wait``).
    ``log_dir`` keeps each rank's output in ``rank{i}.out``/``.err``
    (else a temporary directory, removed with the ``Ranks``)."""
    return Ranks(cmd, n, timeout=timeout, env=env, cwd=cwd,
                 log_dir=log_dir, names=names)


def run_ranks(cmd: Sequence[str], n: int, *, timeout: float,
              env: Optional[dict] = None, cwd=None, log_dir=None,
              names: str = "torchrun") -> list:
    """Run ``cmd`` as ranks 0..n-1 until all exit; each rank's (stdout,
    stderr).  Raises ``RankFailed`` (after killing every rank) where one
    exits non-zero or the ranks outlast ``timeout`` seconds."""
    with start(cmd, n, timeout=timeout, env=env, cwd=cwd, log_dir=log_dir,
               names=names) as ranks:
        return ranks.wait()


def spawn(target: str, n: int, args: tuple = (), *, timeout: float = 600.0,
          backend: str = "gloo", env: Optional[dict] = None,
          log_dir=None, names: str = "torchrun",
          group_timeout: Optional[float] = None, wait: bool = True):
    """``module:function(*args)`` on ``n`` ranks (each in a process group
    of ``n`` over ``backend``, whose collectives time out after
    ``group_timeout`` seconds, ``core.distributed.DEFAULT_TIMEOUT`` where
    None); the return values, in rank order.  ``wait=False`` returns the
    running ``Ranks`` at once; their ``results()`` are the values."""
    env = {**(env or {}), "LADI_DIST_BACKEND": backend}
    if group_timeout is not None:
        env["LADI_DIST_GROUP_TIMEOUT"] = str(group_timeout)
    tmp = tempfile.TemporaryDirectory(prefix="spawn_")
    payload = Path(tmp.name) / "args.pt"
    torch.save(tuple(args), payload)
    ranks = Ranks([sys.executable, "-m", "ladi_vton_tpu_torch.parallel.launch",
                   target, str(payload), tmp.name], n, timeout=timeout,
                  env=env, cwd=None, log_dir=log_dir, names=names,
                  results_dir=tmp)
    if not wait:
        return ranks
    with ranks:
        return ranks.results()


def _main(argv: Sequence[str]) -> None:
    from ladi_vton_tpu_torch.core import distributed

    target, payload, out = argv
    module, name = target.split(":")
    args = torch.load(payload, weights_only=False)
    backend = os.environ["LADI_DIST_BACKEND"]
    group_timeout = os.environ.get("LADI_DIST_GROUP_TIMEOUT")
    distributed.initialize(
        backend=backend, device="cuda" if backend == "nccl" else "cpu",
        timeout=(distributed.DEFAULT_TIMEOUT if group_timeout is None else
                 datetime.timedelta(seconds=float(group_timeout))))
    rank = distributed.rank()  # the function may leave the group itself
    try:
        result = getattr(importlib.import_module(module), name)(*args)
        torch.save(result, Path(out) / f"result{rank}.pt")
        distributed.barrier()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    _main(sys.argv[1:])
