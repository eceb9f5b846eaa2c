"""Start ranks as processes with the launcher's environment, as torchrun.

``run_ranks(cmd, n)`` starts ``n`` copies of a command with torchrun's
variables (``MASTER_ADDR``/``MASTER_PORT`` on a free local port,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), waits for
all of them within ``timeout`` seconds, and kills every one of them when
one fails or the time runs out, so a rank that dies or hangs ends the
run with an error naming it.  ``spawn(target, n, args)`` runs a Python
function ``module:function`` on each rank (this module as the command):
it joins the process group (``core.distributed.initialize``), calls
``function(*args)``, and its return value comes back from every rank,
in rank order, through ``torch.save`` files.

    python -m ladi_vton_tpu_torch.parallel.launch MODULE:FUNCTION ARGS.pt OUT
"""

from __future__ import annotations

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


def run_ranks(cmd: Sequence[str], n: int, *, timeout: float,
              env: Optional[dict] = None, cwd=None, log_dir=None,
              names: str = "torchrun") -> list:
    """Run ``cmd`` as ranks 0..n-1; each rank's (stdout, stderr).  Raises
    ``RankFailed`` (after killing every rank) where one exits non-zero or
    the ranks outlast ``timeout`` seconds.  ``log_dir`` keeps each rank's
    output in ``rank{i}.out``/``.err`` (else a temporary directory)."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        logs = Path(log_dir or tmp)
        logs.mkdir(parents=True, exist_ok=True)
        procs, files = [], []
        for r in range(n):
            out = open(logs / f"rank{r}.out", "w")
            err = open(logs / f"rank{r}.err", "w")
            files.append((out, err))
            procs.append(subprocess.Popen(
                list(cmd), env=rank_env(r, n, port, env, names), cwd=cwd,
                stdout=out, stderr=err, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [i for i, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout} s"
                    break
                time.sleep(0.05)
            else:
                bad = [i for i, p in enumerate(procs) if p.returncode]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for out, err in files:
                out.close()
                err.close()
        texts = [((logs / f"rank{r}.out").read_text(),
                  (logs / f"rank{r}.err").read_text()) for r in range(n)]
    if failed:
        tails = "\n".join(f"--- rank {r} stderr ---\n{err[-4000:]}"
                          for r, (_, err) in enumerate(texts))
        raise RankFailed(f"{' '.join(cmd[:4])}: {failed}\n{tails}")
    return texts


def spawn(target: str, n: int, args: tuple = (), *, timeout: float = 600.0,
          backend: str = "gloo", env: Optional[dict] = None,
          log_dir=None, names: str = "torchrun") -> list:
    """``module:function(*args)`` on ``n`` ranks (each in a process group
    of ``n`` over ``backend``); the return values, in rank order."""
    env = {**(env or {}), "LADI_DIST_BACKEND": backend}
    with tempfile.TemporaryDirectory(prefix="spawn_") as tmp:
        payload = Path(tmp) / "args.pt"
        torch.save(tuple(args), payload)
        run_ranks([sys.executable, "-m", "ladi_vton_tpu_torch.parallel.launch",
                   target, str(payload), tmp], n, timeout=timeout, env=env,
                  log_dir=log_dir, names=names)
        return [torch.load(Path(tmp) / f"result{r}.pt", weights_only=False)
                for r in range(n)]


def _main(argv: Sequence[str]) -> None:
    from ladi_vton_tpu_torch.core import distributed

    target, payload, out = argv
    module, name = target.split(":")
    args = torch.load(payload, weights_only=False)
    backend = os.environ["LADI_DIST_BACKEND"]
    distributed.initialize(backend=backend,
                           device="cuda" if backend == "nccl" else "cpu")
    try:
        result = getattr(importlib.import_module(module), name)(*args)
        torch.save(result, Path(out) / f"result{distributed.rank()}.pt")
        distributed.barrier()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    _main(sys.argv[1:])
