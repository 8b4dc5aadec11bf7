"""Run a payload as N ranks of one process group, for tests and scripts.

The port's counterpart of the JAX package's `repro/substrate/probes.py`.
There a probe is one process with N forced host devices; here it is N
processes (`python -c payload`), each given its rank's environment
(`hostenv.rank_env`: rank, world, a fresh `file://` rendezvous, the
backend, a finite process-group timeout, `src` importable, one thread)
and started from the repo root. The payload joins the group with
`repro_torch.substrate.hostenv.init_from_env()`.

A rank that dies leaves its peers blocked in their next collective, so
`run_probe` kills every rank as soon as any rank exits non-zero or the
timeout passes, and never waits on a hung peer.

A rank ends with `os._exit` once its payload has run (its exit code the
payload's: 0, its `SystemExit` code, or 1 after printing an uncaught
exception), with its output flushed. The interpreter's own teardown is
skipped because, under load, gloo's C++ objects can abort a rank there
after its work is done ("terminate called without an active
exception"), whether or not the payload destroyed its process groups.
"""
from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, NamedTuple

from repro_torch.substrate.compat import DEFAULT_TIMEOUT_S
from repro_torch.substrate.hostenv import rank_env

# repo root = parent of the `src` directory this package lives in
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPO_ROOT = os.path.dirname(_SRC)
_POLL_S = 0.02


class ProbeRun(NamedTuple):
    ranks: List[subprocess.CompletedProcess]   # rank order
    timed_out: bool                            # killed at the timeout

    @property
    def ok(self) -> bool:
        return not self.timed_out and all(r.returncode == 0
                                          for r in self.ranks)

    def report(self) -> str:
        """Every rank's exit code and the tail of its stderr."""
        return "\n".join(f"rank {i}: rc {r.returncode}\n{r.stderr[-2000:]}"
                         for i, r in enumerate(self.ranks))


# runs the payload as a script, then leaves through os._exit with its code
_RANK_MAIN = """
import os, sys, traceback
try:
    exec(compile({payload!r}, "<rank payload>", "exec"),
         {{"__name__": "__main__"}})
    code = 0
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else (e.code is not None)
    if isinstance(e.code, str):
        print(e.code, file=sys.stderr)
except BaseException:
    traceback.print_exc()
    code = 1
sys.stdout.flush()
sys.stderr.flush()
os._exit(int(code))
"""


def _start(payload: str, world: int, backend: str, pg_timeout: float,
           cwd: str | None, init_file: str, out=None, err=None):
    main = _RANK_MAIN.format(payload=payload)
    return [subprocess.Popen(
        [sys.executable, "-c", main],
        stdout=out[i] if out else subprocess.PIPE,
        stderr=err[i] if err else subprocess.PIPE, text=True,
        cwd=cwd or REPO_ROOT, start_new_session=True,
        env=rank_env(i, world, init_file, backend=backend,
                     timeout=pg_timeout, extra_pythonpath=_SRC))
        for i in range(world)]


def _kill(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def run_probe(payload: str, *, world: int = 2, backend: str = "gloo",
              timeout: float = 120.0, pg_timeout: float | None = None,
              cwd: str | None = None) -> ProbeRun:
    """Run `payload` (python source) as `world` ranks and wait for all.

    Every rank is killed (with anything it started) once one rank exits
    non-zero or `timeout` seconds pass. `pg_timeout` bounds each
    collective inside the ranks (default: `timeout`, at most 60 s).
    Returns each rank's exit code, stdout and stderr.
    """
    if pg_timeout is None:
        pg_timeout = min(timeout, DEFAULT_TIMEOUT_S)
    tmp = tempfile.mkdtemp(prefix="repro_probe_")
    out = [open(os.path.join(tmp, f"out{i}"), "w+") for i in range(world)]
    err = [open(os.path.join(tmp, f"err{i}"), "w+") for i in range(world)]
    try:
        procs = _start(payload, world, backend, pg_timeout, cwd,
                       os.path.join(tmp, "rendezvous"), out, err)
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes) \
                        or any(c not in (None, 0) for c in codes):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(_POLL_S)
        finally:
            for p in procs:
                _kill(p)
        ranks = []
        for i, p in enumerate(procs):
            out[i].seek(0)
            err[i].seek(0)
            ranks.append(subprocess.CompletedProcess(
                p.args, p.returncode, out[i].read(), err[i].read()))
        return ProbeRun(ranks, timed_out)
    finally:
        for f in out + err:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def popen_probe(payload: str, *, world: int = 2, backend: str = "gloo",
                pg_timeout: float = DEFAULT_TIMEOUT_S,
                cwd: str | None = None) -> List[subprocess.Popen]:
    """`run_probe` that returns the LIVE ranks instead of waiting.

    The caller owns the processes: `communicate()`/`kill()`/`wait()`
    every one of them. Same environment contract as `run_probe`, stdout
    and stderr piped as text; the rendezvous file lies in a fresh
    temporary directory.
    """
    tmp = tempfile.mkdtemp(prefix="repro_probe_")
    return _start(payload, world, backend, pg_timeout, cwd,
                  os.path.join(tmp, "rendezvous"))
