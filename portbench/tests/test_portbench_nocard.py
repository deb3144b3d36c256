"""The run command on a machine without a card, and in a directory that
holds only the benchmark: a nonzero exit and no result."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench.harness.spec import HERE, ROOT


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "wm_train",
                           "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(rec, dict) and ("device" in rec or "metrics" in rec)), line


def test_portbench_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is a card-less host's")
    out = _run(ROOT)
    assert out.returncode != 0
    _no_result(out)
    assert "card" in out.stderr


def test_portbench_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
