"""On the card: one short run of a cell through ``run.py``, as a check
runs it, comes out correct with every job on the card engine."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "v4_2x250.small_samples", "--seed", str(2 ** 31 + 7 + trace),
         "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["checks"]["jobs_off_engine"]["value"] == 0
    if trace:
        assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
