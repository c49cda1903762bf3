"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal
to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("a,b,cols,want", [
    ([["x", "1"]], [["x", "1"]], (), True),
    ([["x", "1"]], [["x", "2"]], (), False),
    ([["x", "1.0000000000001"]], [["x", "1"]], (1,), True),
    ([["x", "1.000002"]], [["x", "1.000000"]], (1,), False),
    ([["x", "9373.142858"]], [["x", "9373.142857"]], (1,), True),
    ([["x", "9373.142859"]], [["x", "9373.142857"]], (1,), False),
    ([["x", "1"]], [["x", "1"], ["y", "2"]], (), False),
])
def test_rows_match(a, b, cols, want):
    assert (chip_smoke.row_difference(a, b, cols) is None) is want


def test_server_phase_tiny(monkeypatch):
    monkeypatch.setenv("EVENTQL_TPU_DEVICE", "1")
    out = chip_smoke.server_phase(rows=4096, dims=(1024, 2048), reps=2)
    assert set(out["queries"]) == {q[0] for q in chip_smoke.QUERIES}
    assert out["stats"]["evqld.device_route_runs"] > 0


def test_plain_forms_phase_tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DIM_ROWS", (1024, 2048))
    out = chip_smoke.plain_forms_phase(n=1 << 16, reps=1)
    assert all(r["s"] > 0 and r["bytes"] > 0 for r in out.values())


def test_mesh_phase_tiny():
    out = chip_smoke.mesh_phase(4, rows_per_device=2048)
    assert set(out) == {q[0] for q in chip_smoke.MESH_QUERIES}
    assert all(r["collectives"] > 0 for r in out.values())


def _last_line_ok(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]).get("ok") is True
    except (IndexError, ValueError, AttributeError):
        return False


def test_row_difference_names_the_row():
    diff = chip_smoke.row_difference(
        [["x", "1"], ["y", "9373.142859"]],
        [["x", "1"], ["y", "9373.142857"]], (1,))
    assert diff.startswith("row 1 column 1: 9373.142859 against 9373.142857")


@pytest.mark.parametrize("dev,host,ok", [
    ([1.0, 2334.0], [1.0, 2334.0], True),
    ([1.0, 2334.0], [1.0, 2334.0 * (1 + 1e-13)], True),
    ([1.0, 2334.0], [1.0, 2334.0 * (1 + 1e-11)], False),
    ([0.0, 0.0], [0.0, 0.0], True),
])
def test_f64_difference(dev, host, ok):
    import numpy as np

    worst, diff = chip_smoke.f64_difference([np.array(dev)], [np.array(host)])
    assert (diff is None) is ok
    if ok:
        assert worst <= chip_smoke.F64_RTOL
    else:
        assert diff.startswith("column 0 row 1:")


def test_fails_without_gpu(monkeypatch, capsys):
    """On the CPU backend main() stops at the GPU check, after phase 1
    and the card line (both stubbed here), and prints no result."""
    from eventql_tpu.utils import device_info

    monkeypatch.setattr(device_info, "card_line", lambda: "stub card")
    monkeypatch.setattr(chip_smoke, "gpu_tests_phase", lambda: None)
    with pytest.raises(RuntimeError, match="a GPU run was requested"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert not _last_line_ok(r.stdout)
