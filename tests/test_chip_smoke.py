"""chip_smoke.py refuses to run anywhere but on a GPU, and passes there."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=1200)


def test_chip_smoke_fails_without_gpu():
    out = _run(dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_host):
    out = _run({k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
