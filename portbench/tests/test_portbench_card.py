"""Each cell end to end on the card, with a short window: the line is
printed and ``correct`` is true. Run on the card with
``python -m pytest -m gpu portbench/tests``."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from portbench import bench

ROOT = pathlib.Path(bench.__file__).resolve().parent.parent


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in bench.benchmark()["workloads"]])
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 5), "--seconds", "10", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
