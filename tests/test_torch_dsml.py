"""The port's main path (`repro_torch.core.dsml.dsml_fit`, DSML Algorithm
1) against the JAX reference on the CPU, plus the port's isolation from
the reference and from JAX.

`dsml_fit` runs on the reference's own synthetic data at the statistical
tier's regime (m=10, n=120, p=200, s=10) and at a small ragged shape;
every float output agrees within 1e-5 absolute after 1000 chained FISTA
iterations, and the supports are identical. Outputs are compared with
the reference's outputs, never with its golden bands.
"""
from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.dsml import dsml_fit as jax_dsml_fit
from repro.core.synth import gen_regression as jax_gen_regression
from repro_torch.convert import from_reference
from repro_torch.core.dsml import dsml_fit

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("refit", [False, True])
@pytest.mark.parametrize("m, n, p, s", [(10, 120, 200, 10), (3, 40, 44, 4)])
def test_dsml_fit_matches_reference(m, n, p, s, refit):
    data = jax_gen_regression(jax.random.PRNGKey(0), m=m, n=n, p=p, s=s)
    lam = 2.0 * float(np.sqrt(np.log(p) / n))
    mu = float(np.sqrt(np.log(p) / n))
    Lam = 0.5
    want = jax_dsml_fit(data.Xs, data.ys, lam, mu, Lam, refit=refit)
    td = from_reference(data, "cpu")
    got = dsml_fit(td.Xs, td.ys, lam, mu, Lam, refit=refit)
    assert np.array_equal(got.support.numpy(), np.array(want.support))
    assert 0 < int(got.support.sum()) < p
    for name in ("beta_tilde", "beta_u", "beta_local"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.array(getattr(want, name)),
                                   rtol=0, atol=ATOL, err_msg=name)


# ---- isolation --------------------------------------------------------------

_PROBE = """
import pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "repro" or k.startswith("repro."))
missing = sorted({"repro_torch.core.dirty",
                  "repro_torch.kernels.group_threshold.ops",
                  "repro_torch.kernels.group_threshold.ref",
                  "repro_torch.obs.registry",
                  "repro_torch.checkpoint.manifest",
                  "repro_torch.stream.service",
                  "repro_torch.stream.accumulate",
                  "repro_torch.substrate.collectives",
                  "repro_torch.substrate.probes",
                  "repro_torch.multitask.sparse_probe",
                  "repro_torch.models.moe",
                  "repro_torch.models.moe_shard_map",
                  "repro_torch.models.rglru",
                  "repro_torch.models.ssd",
                  "repro_torch.launch.multitask_probes",
                  "repro_torch.testing.faults"} - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 68 else 0)
"""


def test_port_imports_neither_jax_nor_the_reference():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_port_sources_name_no_jax_reference_or_torch_compile():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, mod)
        assert "torch.compile" not in f.read_text(), f


def _run_chip_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs there")
    r = _run_chip_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_chip_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
