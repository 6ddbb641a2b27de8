"""One short run of a cell on the card, as the benchmark's command runs
it (skipped without a CUDA device)."""

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "paper-train-b32", "--seed", "2147483999", "--seconds", "2",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=1200, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {
        m["name"] for m in spec.metrics(spec.benchmark(), "paper-train-b32",
                                        False)}
