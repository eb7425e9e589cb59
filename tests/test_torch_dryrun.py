"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's.

Six cells run in both packages, each package in processes of its own
(`torch_dryrun_worker.py`: the reference forces 512 host devices and
lowers through its ``lower_cell`` on a mesh of Auto axes, reference defect
1; the port runs with JAX blocked on its fake process group).  Per rank,
the port's argument bytes equal the reference's exactly — falcon-mamba-7b
decode_32k adds the 4-byte ``pos`` that the SSM decode never reads and XLA
drops — and qwen1.5-0.5b's dot FLOPs are within 10 % of the reference's.
Every (arch x shape) cell's status and reason equal the reference's
``supports_shape``, and the port's records render through the unchanged
``benchmarks/render_tables.dryrun_table``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import registry

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dryrun_worker.py"
QWEN = ["qwen1.5-0.5b:train_4k:pod_16x16", "qwen1.5-0.5b:prefill_32k:pod_16x16",
        "qwen1.5-0.5b:decode_32k:pod_16x16",
        "qwen1.5-0.5b:decode_32k:multipod_2x16x16"]
OTHERS = ["olmoe-1b-7b:decode_32k:pod_16x16",
          "falcon-mamba-7b:decode_32k:pod_16x16"]
CELLS = QWEN + OTHERS
# the port passes the decode position, 4 bytes the SSM decode never reads
EXTRA_ARG_BYTES = {"falcon-mamba-7b:decode_32k:pod_16x16": 4}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"ref": {cell: record}, "port": {cell: record}}: the reference in
    one process, the port's cells split over two, all three at once, each
    on one thread (the suite's other workers share the cores)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    jobs = {"ref": ("ref", CELLS),
            "port_a": ("port", [CELLS[0], CELLS[2], CELLS[4]]),
            "port_b": ("port", [CELLS[1], CELLS[3], CELLS[5]])}
    procs = {name: subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(tmp / f"{name}.json"),
         *cells], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (mode, cells) in jobs.items()}
    out = {"ref": {}, "port": {}}
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{name}:\n{log[-4000:]}"
            with open(tmp / f"{name}.json") as f:
                out["ref" if name == "ref" else "port"].update(json.load(f))
    finally:
        for proc in procs.values():
            proc.kill()
    return out


def test_every_cell_skips_as_the_reference_does():
    """All 80 (arch x shape x mesh) cells: 66 run and 14 skip, with the
    reference's reasons word for word (skips need no process group)."""
    from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
    from repro.models import registry as ref_registry
    ok = skip = 0
    for arch in ARCHS:
        for shape in SHAPES:
            want, reason = ref_registry.supports_shape(REF_ARCHS[arch],
                                                       REF_SHAPES[shape])
            for multi in (False, True):
                if want:
                    ok += 1
                    continue
                rec = dryrun.run_cell(arch, shape, multi, out_dir=None)
                assert rec["status"] == "SKIP" and rec["reason"] == reason
                skip += 1
            got, _ = registry.supports_shape(ARCHS[arch],
                                             SHAPES[shape])
            assert got == want
    assert (ok, skip) == (66, 14)


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_the_reference(records, cell):
    port, ref = records["port"][cell], records["ref"][cell]
    assert port["status"] == ref["status"] == "OK"
    got = port["memory_analysis"]["argument_size_in_bytes"]
    want = ref["memory_analysis"]["argument_size_in_bytes"]
    assert got == want + EXTRA_ARG_BYTES.get(cell, 0)


@pytest.mark.parametrize("cell", QWEN)
def test_qwen_dot_flops_within_ten_percent(records, cell):
    got = records["port"][cell]["hlo_analysis"]["dot_flops"]
    want = records["ref"][cell]["hlo_analysis"]["dot_flops"]
    assert abs(got / want - 1.0) <= 0.10, (got, want)


def test_other_families_report_their_ratio(records):
    for cell in OTHERS:
        got = records["port"][cell]["hlo_analysis"]["dot_flops"]
        want = records["ref"][cell]["hlo_analysis"]["dot_flops"]
        print(f"{cell}: port/reference dot FLOPs {got / want:.4f}")
        assert got > 0 and want > 0


def test_records_render_through_render_tables(records, tmp_path,
                                              monkeypatch):
    sys.path.insert(0, str(REPO))
    try:
        from benchmarks.render_tables import dryrun_table
    finally:
        sys.path.remove(str(REPO))
    out = tmp_path / "experiments" / "dryrun"
    out.mkdir(parents=True)
    for cell, rec in records["port"].items():
        arch, shape, mesh = cell.split(":")
        with open(out / f"{arch.replace('.', '_')}__{shape}__{mesh}.json",
                  "w") as f:
            json.dump(rec, f)
    monkeypatch.chdir(tmp_path)
    table = dryrun_table().splitlines()
    assert len(table) == 2 + len(CELLS)
    assert all("| OK |" in row for row in table[2:])
    for key in ("dot_flops", "elem_flops", "bytes", "coll_bytes",
                "coll_bytes_total", "wire_bytes_total", "while_trips"):
        assert key in records["port"][CELLS[0]]["hlo_analysis"]
