"""chip_smoke.py outside the card: phase and option selection, and the
contract that it exits non-zero without printing a result when JAX finds
no GPU or the repository is missing."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _phases(*argv):
    return chip_smoke.select_phases(chip_smoke.parse_args(list(argv)))


def test_default_runs_every_one_card_phase():
    assert _phases() == chip_smoke.PHASES
    assert _phases()[0] == "device"
    assert set(chip_smoke.PHASES) | {"multi"} == set(chip_smoke.PHASE_FUNCS)


def test_multi_runs_only_the_sharded_checks():
    assert _phases("--multi") == ("device", "multi")
    with pytest.raises(SystemExit):
        _phases("--multi", "--phases", "teapot")


def test_phase_subset_keeps_order_and_rejects_unknown():
    assert _phases("--phases", "training,reference") == (
        "device", "reference", "training")
    with pytest.raises(SystemExit):
        _phases("--phases", "reference,nope")


def _run(script, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=180)


def test_no_gpu_exits_nonzero_without_result():
    res = _run(ROOT / "chip_smoke.py", ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_alone_without_the_repository_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
