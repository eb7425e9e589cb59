"""The port's examples run on the CPU as a user runs them, with every
import of JAX or the JAX package blocked, and print their OK line; those
with a reference counterpart print the reference example's lines."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

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


# (the port's example, the reference's, its last line)
REFERENCE_EXAMPLES = {
    "quickstart": ("torch_quickstart.py", "quickstart.py", "quickstart OK"),
    "multihost": ("torch_multihost_graph_sharing.py",
                  "multihost_graph_sharing.py",
                  "multihost sharing example OK"),
}


# The reference example run with its memsim's reuse-distance cache made
# sound: that cache is keyed by id(trace) (reference defect 10), so a trace
# allocated where a freed one lived can read the freed trace's LLC misses.
# Clearing it whenever a new pages array arrives (the last one held, so its
# id cannot be reused) gives the same lines as a run in which no id repeats.
REF_RUN = ("import runpy, sys\n"
           "from repro.memsim import model\n"
           "miss_mask, last = model._llc_miss_mask, [None]\n"
           "def sound(trace, cfg):\n"
           "    if last[0] is not trace.pages:\n"
           "        model._rd_cache.clear()\n"
           "        last[0] = trace.pages\n"
           "    return miss_mask(trace, cfg)\n"
           "model._llc_miss_mask = sound\n"
           "runpy.run_path(sys.argv[1], run_name='__main__')\n")


def _port_example(script: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", BLOCK_JAX, str(REPO / "examples" / script),
         *args],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                       "PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("name", list(REFERENCE_EXAMPLES))
def test_example_prints_the_reference_lines_on_the_cpu(name):
    """The port's example with ``--device cpu`` and JAX blocked prints
    every line the reference example prints (run beside it, `REF_RUN`)."""
    port_script, ref_script, ok_line = REFERENCE_EXAMPLES[name]
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_RUN, str(REPO / "examples" / ref_script)],
        cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = _port_example(port_script, "--device", "cpu")
    out, err = port.communicate(timeout=300)
    ref_out, ref_err = ref.communicate(timeout=300)
    assert port.returncode == 0, out + err
    assert ref.returncode == 0, ref_out + ref_err
    lines = out.splitlines()
    assert lines[-1] == ok_line
    assert lines == ref_out.splitlines()


@pytest.mark.parametrize("name", list(REFERENCE_EXAMPLES))
def test_example_without_a_device_needs_the_card(name):
    """With no ``--device`` and no CUDA device the example raises before
    it runs anything: only ``--device cpu`` runs the CPU versions."""
    port = _port_example(REFERENCE_EXAMPLES[name][0])
    out, err = port.communicate(timeout=300)
    assert port.returncode != 0
    assert out == ""
    assert "no CUDA device is available" in err
