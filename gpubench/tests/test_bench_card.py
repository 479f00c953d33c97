"""On the card: a short run of each cell prints a correct result line. Marked
``cuda``; skips without a card (decided in the fixture, not at import).

    python -m pytest gpubench/tests -m cuda      # on a machine with the card
"""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vit_h.embed_b8", "vit_b.embed_b8"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 101), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
