"""The timed path broken underneath: each fault a cell can have makes the
run come out not correct. The harness's look for a card is skipped (the
CPU runs the program's plain path); everything else is a whole run."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from bench import run
from conftest import ROOT

import repro_torch.core.dsml as dsml_mod
import repro_torch.core.engine as engine
import repro_torch.stream.service as service


def unchanged_step(monkeypatch):
    """A FISTA step that hands back its iterate unchanged."""
    monkeypatch.setattr(engine, "fista_step_batched",
                        lambda Sig, Z, X, *a, **k: (X, Z))


def half_batch(monkeypatch):
    """Sufficient statistics of the first half of each task's rows."""
    orig = engine.rank_update

    def half(Xs, ys, weights=None, **kw):
        h = Xs.shape[1] // 2
        return orig(Xs[:, :h].contiguous(), ys[:, :h].contiguous(),
                    None if weights is None else weights[:, :h], **kw)
    monkeypatch.setattr(engine, "rank_update", half)


def nudge(t: torch.Tensor) -> torch.Tensor:
    """One entry moved by a hundredth of the output's scale."""
    out = t.clone()
    out.view(-1)[0] += 0.01 * torch.max(torch.abs(t)).clamp_min(1.0)
    return out


def altered_fit(monkeypatch):
    orig = dsml_mod.debias_batched
    monkeypatch.setattr(dsml_mod, "debias_batched",
                        lambda *a, **k: nudge(orig(*a, **k)))


def altered_grid(monkeypatch):
    orig = engine.solve_lasso_grid
    monkeypatch.setattr(engine, "solve_lasso_grid",
                        lambda *a, **k: nudge(orig(*a, **k)))


def altered_answer(monkeypatch):
    orig = service._predict_shared
    monkeypatch.setattr(service, "_predict_shared",
                        lambda *a, **k: nudge(orig(*a, **k)))


FAULTS = {
    "dsml-reg.fit": [unchanged_step, half_batch, altered_fit],
    "dsml-reg.lambda-grid": [unchanged_step, half_batch, altered_grid],
    "dsml-stream.ingest-serve": [unchanged_step, half_batch, altered_answer],
}
CASES = [(w, f) for w, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_is_not_correct(small_root, monkeypatch, capsys, workload,
                              fault):
    fault(monkeypatch)
    rc = run.main(["--workload", workload, "--seed", "97", "--seconds", "0.5",
                   "--root", str(small_root)], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, line["checks"]


# the many-card cell: its ranks are processes of their own, so each fault
# goes in through a `sitecustomize` on their path as well as into rank 0
SITE = {
    "unchanged_step": """
import repro_torch.core.engine as engine
engine.fista_step_batched = lambda Sig, Z, X, *a, **k: (X, Z)
""",
    "half_batch": """
import repro_torch.core.engine as engine
_orig = engine.rank_update
def _half(Xs, ys, weights=None, **kw):
    h = Xs.shape[1] // 2
    return _orig(Xs[:, :h].contiguous(), ys[:, :h].contiguous(), None, **kw)
engine.rank_update = _half
""",
    "no_exchange": """
import repro_torch.core.dsml as dsml
import torch.distributed as dist
dsml.all_gather_tasks = lambda x, *a, **k: x.repeat(dist.get_world_size(), 1)
""",
    "altered_fit": """
import torch
import repro_torch.core.dsml as dsml
_orig = dsml.debias_batched
def _nudged(*a, **k):
    out = _orig(*a, **k).clone()
    out.view(-1)[0] += 0.01 * torch.max(torch.abs(out)).clamp_min(1.0)
    return out
dsml.debias_batched = _nudged
""",
}


@pytest.mark.parametrize("fault", list(SITE))
def test_sharded_fault_is_not_correct(small_root, tmp_path, fault):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITE[fault])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(site), str(ROOT / "src"),
                                           str(ROOT)]))
    code = ("import sys; from bench import run; sys.exit(run.main("
            f"['--workload', 'dsml-reg.fit-4chip', '--seed', '97', "
            f"'--seconds', '0.5', '--root', {str(small_root)!r}], "
            "device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
