"""Rank processes on one machine, for the dry run, the tests and the card's
smoke run.

    results = launch.run(8, "package.module:function", payload, backend="gloo")

starts n processes of `python -m psvo_tpu_torch.parallel.launch`, each with
RANK, WORLD_SIZE and LOCAL_RANK in its environment. Each joins one process
group through a `file://` rendezvous in a fresh temporary directory (no
port to pick), calls function(payload) and saves what it returns; `run`
returns the ranks' results in rank order. The payload and the results go
through `torch.save` / `torch.load(weights_only=True)`: tensors, numbers,
strings, lists, tuples and dicts. A rank that fails, or a run past its
deadline, stops every rank and raises with the end of each rank's output.

`python -m torch.distributed.run` starts ranks the same way for the command
line (`cli.py`), which rendezvouses through its environment instead.
"""

from __future__ import annotations

import datetime
import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

_ROOT = str(Path(__file__).resolve().parents[2])  # the directory holding the package


def rank_device(kind: str) -> torch.device:
    """The device of this rank: the CPU, or the card LOCAL_RANK modulo the
    cards present (every rank on cuda:0 on a machine with one)."""
    if kind == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    device = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def run(n_ranks: int, target: str, payload=None, *, backend: str = "gloo",
        timeout: float = 600.0, pythonpath=()) -> list:
    """Run target(payload) on n_ranks ranks of one process group; return
    their results in rank order. `pythonpath` adds directories where the
    target's module is found. Each rank runs one intra-op thread: the ranks
    share the machine's cores."""
    with tempfile.TemporaryDirectory(prefix="psvo_ranks_") as tmp:
        tmp = Path(tmp)
        torch.save(payload, tmp / "payload.pt")
        env = dict(os.environ, WORLD_SIZE=str(n_ranks), PSVO_DIST_BACKEND=backend,
                   PSVO_DIST_INIT=f"file://{tmp / 'rendezvous'}",
                   PSVO_RANK_TIMEOUT=str(int(timeout)),
                   PYTHONPATH=os.pathsep.join([_ROOT, *map(str, pythonpath),
                                               os.environ.get("PYTHONPATH", "")]))
        procs, logs = [], []
        try:
            for r in range(n_ranks):
                log = open(tmp / f"rank{r}.log", "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "psvo_tpu_torch.parallel.launch", target,
                     str(tmp / "payload.pt"), str(tmp / f"rank{r}.pt")],
                    stdout=log, stderr=subprocess.STDOUT,
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    raise RuntimeError(_failure(tmp, procs, failed, timeout))
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.returncode != 0]
            if failed:
                raise RuntimeError(_failure(tmp, procs, failed, timeout))
            return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(n_ranks)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()


def _failure(tmp: Path, procs, failed, timeout) -> str:
    what = (f"rank(s) {failed} exited with {[procs[r].returncode for r in failed]}" if failed
            else f"the ranks ran past {timeout:.0f} s")
    tails = []
    for r in range(len(procs)):
        lines = (tmp / f"rank{r}.log").read_text(errors="replace").splitlines()[-15:]
        tails.append(f"--- rank {r} ---\n" + "\n".join(lines))
    return f"{what}; the end of each rank's output:\n" + "\n".join(tails)


def _rank_main(target: str, payload_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        os.environ["PSVO_DIST_BACKEND"], init_method=os.environ["PSVO_DIST_INIT"],
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=int(os.environ.get("PSVO_RANK_TIMEOUT", "600"))))
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        torch.save(fn(torch.load(payload_path, weights_only=True)), out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:4])
