"""The port's distributed substrate (`repro_torch.substrate`), its sharded
ingest (`repro_torch.stream.accumulate`) and the stream service's
`mesh=` branch, on gloo ranks on the CPU, against the JAX reference.

Multi-rank cases run through `run_probe` (one thread a rank, a 120 s
limit, a 60 s process-group timeout) on a 2 x 2 data x task mesh, on
inputs built by the reference and handed over as numpy arrays:

* the mesh helpers' coordinates and group membership;
* `feed_chunk` against `feed_shards` (the same blocks, bit for bit), and
  `feed_shards`' errors with the reference's messages;
* `accumulate_stats_sharded` and `ingest_sharded` against the
  reference's `sufficient_stats` and `ingest` on the same chunks (within
  1e-5), two `psum_stats` a chunk by the ledger and by the wrapped
  `torch.distributed` functions;
* `all_to_all_experts` and `all_gather_tasks` against a numpy model;
* a guarded `StreamingDsmlService(mesh=...)` run with a poisoned chunk
  and a divergence forced on one rank only, against the reference's
  unsharded service: the same verdicts, generations, rollbacks,
  intervals and supports at every step, every rank's state block
  within 1e-5.

And without ranks: `run_probe` kills every rank when one fails or the
time runs out, `rank_env`'s environment, and the kernel build's
up-to-date test on stub files (no `nvcc`).
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.stream as jstream
from repro.core import gen_regression as jax_gen_regression
from repro.core import sufficient_stats as jax_sufficient_stats
from repro.stream.guard import IngestGuard as JaxIngestGuard
from repro.substrate import feed_shards as jax_feed_shards
from repro.testing import DivergenceInjector as JaxDivergenceInjector
from repro.testing import apply_batch_fault as jax_apply_batch_fault
from repro.testing import make_clean_batch as jax_make_clean_batch
from repro_torch.kernels import _build
from repro_torch.substrate import rank_env, run_probe

M, N, P, S, K = 4, 120, 48, 5, 3        # K chunks of N / K rows
LAM, MU, THR = 0.4, 0.2, 1.0
ATOL = 1e-5


def _results(run):
    assert run.ok, run.report()
    out = []
    for r in run.ranks:
        line = [s for s in r.stdout.splitlines() if s.startswith("RESULT ")]
        assert len(line) == 1, r.stdout
        out.append(json.loads(line[0][len("RESULT "):]))
    return out


# ---------------------------------------------------------------------------
# the 2 x 2 grid: mesh, feed, sharded ingest, collectives
# ---------------------------------------------------------------------------

_GRID = r"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import obs
from repro_torch.stream import (
    accumulate_stats_sharded, ingest_sharded, init_stream_state,
)
from repro_torch.substrate import (
    all_gather_tasks, all_to_all_experts, data_model_mesh, data_task_mesh,
    feed_chunk, feed_shards, init_from_env, task_mesh,
)
from repro_torch.testing import count_collectives

rank, world = init_from_env()
mesh = data_task_mesh(n_task=2)
d = np.load({path!r})
X_all, y_all = torch.from_numpy(d["Xs"]), torch.from_numpy(d["ys"])
out = {{"rank": rank, "coord": list(mesh.get_coordinate()),
        "data_ranks": dist.get_process_group_ranks(mesh.get_group("data")),
        "task_ranks": dist.get_process_group_ranks(mesh.get_group("task")),
        "model_ranks": dist.get_process_group_ranks(
            data_model_mesh(2).get_group("model")),
        "task_mesh": list(task_mesh().mesh.tolist())}}

chunks = list(zip(torch.chunk(X_all, {k}, dim=1), torch.chunk(y_all, {k}, dim=1)))
same = True
for X, y in chunks:
    a = feed_chunk(X, y, mesh)
    b = feed_shards(torch.chunk(X, 2, dim=1), torch.chunk(y, 2, dim=1), mesh)
    same &= all(torch.equal(u, v) for u, v in zip(a, b))
out["feed_same"] = bool(same)

errors = []
X, y = chunks[0]
for Xb, yb in ((torch.chunk(X, 3, dim=1), torch.chunk(y, 3, dim=1)),
               ([X[:3, :20], X[:3, 20:]], [y[:3, :20], y[:3, 20:]]),
               ([X[:, :20], X[:, 20:]], [y[:, :20], y[:, 19:]])):
    try:
        feed_shards(list(Xb), list(yb), mesh)
        errors.append(None)
    except ValueError as e:
        errors.append(str(e))
out["errors"] = errors

S0, c0 = accumulate_stats_sharded(*feed_chunk(X, y, mesh), mesh)
np.savez({out_dir!r} + f"/acc{{rank}}.npz", S=S0.numpy(), c=c0.numpy())

state = init_stream_state(2, X_all.shape[2], device="cpu")
obs.reset()
with count_collectives() as calls:
    for X, y in chunks:
        state = ingest_sharded(state, *feed_chunk(X, y, mesh), mesh)
out["calls"] = dict(calls)
out["psum_calls"] = obs.counter_total("collective.calls", op="psum_stats",
                                      axis="data")
out["psum_bytes"] = obs.counter_total("collective.bytes", op="psum_stats",
                                      axis="data")
np.savez({out_dir!r} + f"/state{{rank}}.npz", Sigmas=state.Sigmas.numpy(),
         cs=state.cs.numpy(), counts=state.counts.numpy())

x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100 * rank
out["a2a"] = all_to_all_experts(x, mesh, "task").tolist()
out["a2a_t"] = all_to_all_experts(x.T.contiguous(), mesh, "task",
                                  split_axis=1, concat_axis=1).tolist()
out["gathered"] = all_gather_tasks(torch.tensor([[rank]]), mesh,
                                   "data").flatten().tolist()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The reference's chunks and one world-4 run of `_GRID`."""
    data = jax_gen_regression(jax.random.PRNGKey(0), m=M, n=N, p=P, s=S)
    Xs, ys = np.array(data.Xs), np.array(data.ys)
    tmp = tmp_path_factory.mktemp("grid")
    np.savez(tmp / "data.npz", Xs=Xs, ys=ys)
    run = run_probe(_GRID.format(path=str(tmp / "data.npz"),
                                 out_dir=str(tmp), k=K),
                    world=4, timeout=120, pg_timeout=60)
    lines = _results(run)
    return Xs, ys, lines, tmp


def _block(rank):
    """(tasks, rows of a chunk) of `rank` at (data, task) = divmod(rank, 2)."""
    d, t = divmod(rank, 2)
    return slice(2 * t, 2 * t + 2), d


def test_mesh_helpers_place_ranks_row_major(grid):
    _, _, lines, _ = grid
    for rank, line in enumerate(lines):
        d, t = divmod(rank, 2)
        assert line["coord"] == [d, t]
        assert line["data_ranks"] == [t, t + 2]
        assert line["task_ranks"] == [2 * d, 2 * d + 1]
        assert line["model_ranks"] == [2 * d, 2 * d + 1]
        assert line["task_mesh"] == [0, 1, 2, 3]


def test_feed_chunk_equals_feed_shards(grid):
    assert all(line["feed_same"] for line in grid[2])


def test_feed_shards_errors_match_reference(grid):
    """The reference's messages, word for word: its own on a 1-device
    mesh for a wrong block count and a wrong block shape, and its
    message for tasks that do not split over the task dim."""
    Xs, ys, lines, _ = grid
    X, y = Xs[:, :N // K], ys[:, :N // K]
    mesh = jax.make_mesh((1, 1), ("data", "task"))
    want = []
    for Xb, yb in (([X[:, :20], X[:, 20:]], [y[:, :20], y[:, 20:]]),
                   ([X[:, :40]], [y[:, :39]])):
        with pytest.raises(ValueError) as e:
            jax_feed_shards(Xb, yb, mesh)
        want.append(str(e.value))
    for line in lines:
        got = line["errors"]
        assert got[0] == want[0].replace("got 2", "got 3").replace(
            "with 1 'data'", "with 2 'data'"), got
        assert got[1] == "m=3 tasks not divisible by task=2", got
        assert got[2] == ("row block 1 has shape (4, 20, 48)/(4, 21); "
                          "every block must be (4, 20, 48)/(4, 20)"), got
        assert want[1] == ("row block 0 has shape (4, 40, 48)/(4, 39); "
                           "every block must be (4, 40, 48)/(4, 40)")


def test_accumulate_stats_sharded_matches_reference(grid):
    Xs, ys, lines, tmp = grid
    X, y = Xs[:, :N // K], ys[:, :N // K]
    S_ref, c_ref = (np.array(a) for a in jax_sufficient_stats(X, y))
    for rank in range(len(lines)):
        tasks, _ = _block(rank)
        got = np.load(tmp / f"acc{rank}.npz")
        np.testing.assert_allclose(got["S"], S_ref[tasks], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got["c"], c_ref[tasks], rtol=0,
                                   atol=ATOL)


def test_ingest_sharded_matches_reference_ingest(grid):
    Xs, ys, lines, tmp = grid
    ref = jstream.init_stream_state(M, P)
    for Xc, yc in zip(np.split(Xs, K, axis=1), np.split(ys, K, axis=1)):
        ref = jstream.ingest(ref, jnp.asarray(Xc), jnp.asarray(yc))
    blocks = {}
    for rank in range(len(lines)):
        tasks, d = _block(rank)
        got = np.load(tmp / f"state{rank}.npz")
        for name in ("Sigmas", "cs", "counts"):
            np.testing.assert_allclose(
                got[name], np.array(getattr(ref, name))[tasks], rtol=0,
                atol=ATOL, err_msg=f"rank {rank} {name}")
        # ranks of one task block hold the same sums, bit for bit
        if tasks.start in blocks:
            np.testing.assert_array_equal(got["Sigmas"], blocks[tasks.start])
        blocks[tasks.start] = got["Sigmas"]


def test_ingest_sharded_is_two_psums_a_chunk(grid):
    """Two all-reduces a chunk (Sigma, c) over `data`, by the ledger and
    by the wrapped functions; bytes = 2 participants x local nbytes."""
    _, _, lines, _ = grid
    ml = M // 2
    for line in lines:
        assert line["calls"] == {"all_reduce": 2 * K}, line
        assert line["psum_calls"] == 2 * K
        assert line["psum_bytes"] == K * 2 * 4 * (ml * P * P + ml * P)


def test_all_to_all_experts_matches_model(grid):
    """Untiled, split and concat on dim 0: slice j goes to the j-th rank
    of the group, received slices stacked in group order."""
    _, _, lines, _ = grid
    for rank, line in enumerate(lines):
        d, t = divmod(rank, 2)
        peers = [2 * d, 2 * d + 1]
        xs = {r: np.arange(6, dtype=np.float32).reshape(2, 3) + 100 * r
              for r in peers}
        want = np.stack([xs[r][t] for r in peers])
        np.testing.assert_array_equal(np.array(line["a2a"]), want)
        np.testing.assert_array_equal(np.array(line["a2a_t"]), want.T)


def test_all_gather_tasks_concatenates_in_group_order(grid):
    _, _, lines, _ = grid
    for rank, line in enumerate(lines):
        assert line["gathered"] == [rank % 2, rank % 2 + 2]


# ---------------------------------------------------------------------------
# the stream service's mesh= branch against the unsharded reference
# ---------------------------------------------------------------------------

_STEPS, _ARM_AT = 18, 7
_KINDS = {3: "nan", 6: "outlier", 9: "inf"}
_SVC = dict(refit_every=80, max_refit_interval=320, lasso_iters=200,
            debias_iters=200)

_SERVICE = r"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import obs
from repro_torch.stream import IngestGuard, StreamingDsmlService
from repro_torch.substrate import data_task_mesh, init_from_env
from repro_torch.testing import DivergenceInjector

rank, world = init_from_env()
mesh = data_task_mesh(n_task=2)
d = np.load({path!r})
svc = StreamingDsmlService({m}, {p}, lam={lam}, mu={mu}, Lam={thr},
                           device="cpu", guard=IngestGuard(warmup_chunks=1),
                           mesh=mesh, **{svc!r})
inj = DivergenceInjector(svc)
obs.reset()
steps = []
for step in range({steps}):
    if step == {arm} and rank == 0:
        inj.arm(1)           # one rank's candidate only
    info = svc.ingest(d[f"X{{step}}"], d[f"y{{step}}"])
    steps.append([info is None, svc.generation, svc.rollbacks,
                  svc._interval, svc._since_refit,
                  np.flatnonzero(svc.state.support.numpy()).tolist()])
np.savez({out_dir!r} + f"/svc{{rank}}.npz",
         **{{k: v.numpy() for k, v in svc.state._asdict().items()}})
print("RESULT " + json.dumps({{
    "steps": steps, "quarantined": svc.guard.total_quarantined,
    "reasons": [r.reason for r in svc.guard.ledger],
    "pmax": obs.counter_total("collective.calls", op="pmax"),
    "gathers": obs.counter_total("collective.calls", op="all_gather_tasks"),
    "attempts": obs.counter_total("stream.refit.count")
                + obs.counter_total("stream.refit.rejected")}}))
"""


@pytest.fixture(scope="module")
def service_run(tmp_path_factory):
    """The reference service's steps and one world-4 run of `_SERVICE`
    on the same chunks."""
    rng = np.random.default_rng(21)
    ref = jstream.StreamingDsmlService(
        M, P, lam=LAM, mu=MU, Lam=THR,
        guard=JaxIngestGuard(warmup_chunks=1), **_SVC)
    jinj = JaxDivergenceInjector(ref)
    chunks, want = {}, []
    for step in range(_STEPS):
        X, y = jax_make_clean_batch(rng, M, 40, P)
        if step in _KINDS:
            X, y = jax_apply_batch_fault(X, y, _KINDS[step], rng)
        if step == _ARM_AT:
            jinj.arm(1)
        chunks[f"X{step}"], chunks[f"y{step}"] = np.array(X), np.array(y)
        info = ref.ingest(jnp.asarray(X), jnp.asarray(y))
        want.append([info is None, ref.generation, ref.rollbacks,
                     ref._interval, ref._since_refit,
                     np.flatnonzero(np.array(ref.state.support)).tolist()])
    tmp = tmp_path_factory.mktemp("service")
    np.savez(tmp / "chunks.npz", **chunks)
    run = run_probe(_SERVICE.format(
        path=str(tmp / "chunks.npz"), out_dir=str(tmp), m=M, p=P, lam=LAM,
        mu=MU, thr=THR, svc=_SVC, steps=_STEPS, arm=_ARM_AT),
        world=4, timeout=120, pg_timeout=60)
    return ref, want, _results(run), tmp


def test_service_mesh_matches_reference_steps(service_run):
    """Verdicts, generations, rollbacks, intervals and supports at every
    step, on every rank (the forced divergence on rank 0 alone rolls
    every rank back)."""
    ref, want, lines, _ = service_run
    assert ref.rollbacks == 1 and ref.generation >= 3
    for rank, line in enumerate(lines):
        assert line["steps"] == want, rank


def test_service_mesh_quarantines_match_reference(service_run):
    ref, _, lines, _ = service_run
    want = [r.reason for r in ref.guard.ledger]
    assert len(want) == 3
    for line in lines:
        assert line["quarantined"] == ref.guard.total_quarantined
        assert line["reasons"] == want


def test_service_mesh_state_blocks_match_reference(service_run):
    ref, _, lines, tmp = service_run
    for rank in range(len(lines)):
        tasks, _ = _block(rank)
        got = np.load(tmp / f"svc{rank}.npz")
        for name in ("Sigmas", "cs", "counts", "beta_local", "beta_u",
                     "beta_tilde", "Ms"):
            np.testing.assert_allclose(
                got[name], np.array(getattr(ref.state, name))[tasks],
                rtol=0, atol=ATOL, err_msg=f"rank {rank} {name}")
        np.testing.assert_array_equal(got["support"],
                                      np.array(ref.state.support))
        assert int(got["generation"]) == ref.generation


def test_service_mesh_shares_one_verdict_per_refit(service_run):
    """Each refit attempt gathers once over `task` and takes the health
    verdict's max over both mesh dims: one `pmax` per dim."""
    _, _, lines, _ = service_run
    for line in lines:
        assert line["attempts"] >= 4
        assert line["gathers"] == line["attempts"]
        assert line["pmax"] == 2 * line["attempts"]


# ---------------------------------------------------------------------------
# probes, rank environments, the kernel build
# ---------------------------------------------------------------------------

def test_run_probe_kills_every_rank_when_one_fails():
    """Rank 1 exits 3 before joining; ranks 0 and 2 would wait for it in
    the rendezvous for the whole process-group timeout."""
    payload = ("import os, sys\n"
               "if os.environ['RANK'] == '1':\n"
               "    sys.exit(3)\n"
               "from repro_torch.substrate import init_from_env\n"
               "init_from_env()\n")
    t0 = time.monotonic()
    run = run_probe(payload, world=3, timeout=60, pg_timeout=60)
    assert time.monotonic() - t0 < 30
    assert not run.ok and not run.timed_out
    assert [r.returncode for r in run.ranks] == [-9, 3, -9]


def test_run_probe_kills_every_rank_at_its_timeout():
    t0 = time.monotonic()
    run = run_probe("import time\ntime.sleep(600)\n", world=2, timeout=2)
    assert time.monotonic() - t0 < 30
    assert run.timed_out and not run.ok
    assert [r.returncode for r in run.ranks] == [-9, -9]


def test_popen_probe_hands_over_live_ranks():
    from repro_torch.substrate import popen_probe
    procs = popen_probe("import os\nprint(os.environ['RANK'], "
                        "os.environ['WORLD_SIZE'])\n", world=2)
    outs = [p.communicate(timeout=60)[0].split() for p in procs]
    assert outs == [["0", "2"], ["1", "2"]]
    assert [p.returncode for p in procs] == [0, 0]


def test_rank_env_gives_each_rank_its_place():
    env = rank_env(2, 4, "/x/rendezvous", backend="nccl", timeout=30,
                   extra_pythonpath="/src", base={"PYTHONPATH": "/a"})
    assert (env["RANK"], env["WORLD_SIZE"], env["REPRO_INIT_FILE"],
            env["REPRO_BACKEND"], float(env["REPRO_PG_TIMEOUT"])) == \
        ("2", "4", "/x/rendezvous", "nccl", 30.0)
    assert env["PYTHONPATH"] == "/src" + os.pathsep + "/a"
    assert env["OMP_NUM_THREADS"] == env["MKL_NUM_THREADS"] == "1"


def test_kernel_build_skips_only_up_to_date_libraries(tmp_path):
    """A library is loaded as it is only when it is newer than its source
    and was built with the same flags (stub files, no nvcc)."""
    src = tmp_path / "kern.cu"
    src.write_text("// stub")
    lib, record = tmp_path / "libkern.so", tmp_path / "libkern.flags"
    assert not _build.up_to_date(src, tmp_path)            # nothing built
    lib.write_text("stub")
    assert not _build.up_to_date(src, tmp_path)            # no flags record
    record.write_text(_build._flags_text())
    t = src.stat().st_mtime_ns
    os.utime(lib, ns=(t + 10**9, t + 10**9))
    assert _build.up_to_date(src, tmp_path)
    assert not _build.up_to_date(src, tmp_path, flags=("-O0",))
    os.utime(src, ns=(t + 2 * 10**9, t + 2 * 10**9))       # source edited
    assert not _build.up_to_date(src, tmp_path)
