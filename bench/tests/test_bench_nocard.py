"""The measurement path needs the cards: without them, and in a checkout
that holds only the benchmark, a run exits non-zero and prints no line."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from bench import harness
from conftest import ROOT


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit):
        harness.require_cards(1)


def test_too_few_cards(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(SystemExit):
        harness.require_cards(4)


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "dsml-reg.fit",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_command_line_refuses_the_cpu():
    proc = _cli(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_alone_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = _cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
