"""The port's examples run on the CPU as a user runs them, with every
import of JAX or the JAX package blocked, and print their OK line."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCK_JAX = ("import runpy, sys\n"
             "for name in ('jax', 'jaxlib', 'repro'):\n"
             "    sys.modules[name] = None\n"
             "sys.argv = [sys.argv[1], *sys.argv[2:]]\n"
             "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def test_serve_shared_experts_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX,
         str(REPO / "examples" / "torch_serve_shared_experts.py"),
         "--device", "cpu"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == ("tenant B unaffected by A's revocation — isolation "
                         "holds.  OK")
    assert "tenant A (revoked)     : denied expert fetches= 48" in \
        proc.stdout


def test_train_isolated_tenants_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX,
         str(REPO / "examples" / "torch_train_isolated_tenants.py"),
         "--device", "cpu"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "train_isolated_tenants OK"
    assert lines[-2] == ("checkpoint leaf encrypts/decrypts with the host "
                         "key. OK")
    assert "restored checkpoint at step 40; continuing 10 more steps" in \
        lines
