"""chip_smoke.py and bench.py off the card: both refuse to run without a GPU
(non-zero exit, no result line), and chip_smoke's phases run end to end at
a tiny size on the CPU mesh."""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402

# 28x48 physical grid, 80 steps; nx=68 gives the 5 shots that pad to 8 on
# a 4-device mesh (the reference's 19 on 4 pads to 20)
TINY = ["--nz", "28", "--nx", "48", "--nt", "80", "--npml", "8"]


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    _no_result(_run_script(os.path.join(REPO, script), REPO))


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _no_result(_run_script(str(tmp_path / "chip_smoke.py"), tmp_path))


def test_phase_device_refuses_cpu(capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        cs.phase_device()
    assert "platform=cpu" in capsys.readouterr().out


def test_phase_forward_tiny():
    r = cs.phase_forward("cpu", TINY)
    assert np.asarray(r["data"]).shape == (3, 4, 28, 80)
    assert r["GCell_per_s"] > 0


def test_gradient_memory_tiny_chunks():
    """The Marmousi acquisition cut to 40x120 with a budget of two shots'
    strips: auto_shot_chunk picks 2 and the chunked gradient is finite."""
    from sep2023_tpu import parallel

    cfg, survey, lam, mu, rho = bench.marmousi_problem(
        nz=40, nx=120, nt=120, n_shots=5, npml=8)
    r = cs.gradient_memory("tiny marmousi", "cpu", cfg, survey, lam, mu,
                           rho, budget_bytes=2 * parallel.strip_bytes_per_shot(
                               cfg))
    assert r["chunk"] == 2 and r["seconds"] > 0


def test_phase_correctness_tiny():
    """Both engines against plain AD in float32 and float64 at 28x48 /
    nt=120 (within the card's bounds), plus the Aki & Richards check."""
    cs.phase_correctness("cpu", nz=28, nx=48, nt=120, shots=(0, 2))
    e = cs.engine_errors(jnp.dtype("float64"), nz=28, nx=48, nt=120,
                         shots=(0, 2))
    assert max(e["elastic"][1], e["acoustic"][1]) < 1e-12


def test_phase_invert_tiny():
    cs.phase_invert("cpu", [*TINY, "--x64"])
    hist = np.loadtxt(os.path.join(cs.WORK, "invert", "Results",
                                   "loss.txt"), ndmin=2)[:, 1]
    assert len(hist) == 3


def test_phase_four_tiny():
    """The --four path on 4 of the 8 virtual devices: sharded invert
    trajectory equals the single-device one."""
    args = ["--nz", "28", "--nx", "68", "--nt", "80", "--npml", "8", "--x64"]
    cs.phase_four("cpu", n_devices=4, cli_args=args, rtol=1e-6)

