"""chip_smoke.py refuses to run without a GPU: no CPU fallback, and no
result line."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_device_check_raises_on_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_main_exits_nonzero_without_result(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Outside the repository (the script and nothing else) it exits
    non-zero and prints no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
