"""chip_smoke.py's phases at a tiny size on the CPU, with the GPU kernels in
the Pallas interpreter — the rehearsal of the run on the card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY_A = dict(n=300, k=8, edges=None, perms=40, seed=3)


@pytest.fixture(scope="module")
def phase_a():
    return chip_smoke.phase_a(impl="interpret", **TINY_A)


def test_phase_a_example1(phase_a, capsys):
    assert phase_a["window"] % 128 == 0
    assert phase_a["counts"].shape == (TINY_A["n"], 1)


def test_phase_b_dense(phase_a):
    chip_smoke.phase_b(phase_a, impl="interpret")


def test_phase_c_go(phase_a):
    chip_smoke.phase_c(phase_a, attrs=24, impl="interpret")


def test_phase_d_band():
    out = chip_smoke.phase_d(n=700, k=6, attrs=12, perms=30, seed=1,
                             impl="interpret")
    assert out["bt"] >= 1


@pytest.mark.parametrize("window,bt,n_dense,block", [
    (256, 1, 200, 64), (192, 2, 100, 32)])
def test_phase_e_kernels(window, bt, n_dense, block):
    chip_smoke.phase_e(window=window, bt=bt, n_dense=n_dense, block=block,
                       impl="interpret")


def test_phase_mesh_on_virtual_devices():
    chip_smoke.phase_mesh(ndev=4, n_band=600, k_band=6, attrs=8, n=300, k=8,
                          edges=None, perms=40, seed=2, impl="interpret")


def test_check_raises_above_tolerance(capsys):
    chip_smoke.check("x", 0.5, 1.0)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("y", 2.0, 1.0)
    out = capsys.readouterr().out
    assert "tolerance" in out and "FAILED" in out


def test_main_refuses_the_cpu(tmp_path):
    """Off the GPU the script exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_alone_it_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo it
    fails (no package to import) and prints no result."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
