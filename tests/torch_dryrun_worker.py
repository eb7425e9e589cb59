"""Dry-run cells of either package, each package in a process of its own.

    python tests/torch_dryrun_worker.py ref OUT.json ARCH:SHAPE:MESH ...
    python tests/torch_dryrun_worker.py port OUT.json ARCH:SHAPE:MESH ...
    python tests/torch_dryrun_worker.py table REF.json PORT.json|PORT_DIR

MESH is ``pod_16x16`` or ``multipod_2x16x16``; ``all`` in place of the cells
means every arch x shape x mesh.  ``ref`` lowers the reference's
``lower_cell`` on a mesh of Auto axes (``jax.make_mesh(...,
axis_types=(AxisType.Auto,) * n)``): its own ``run_cell`` builds Explicit
axes on this jax and fails every cell in ``constrain`` (reference defect
1).  It forces 512 host devices, so it needs a process of its own.
``port`` runs ``repro_torch.launch.dryrun.run_cell`` with JAX and the JAX
package blocked, on the fake process group the dry run makes.  Both write
{cell: record} with the reference's keys; ``table`` prints the markdown
comparison that PERF.md keeps, from a ``port`` file or from the directory
of records ``python -m repro_torch.launch.dryrun`` writes.
"""
from __future__ import annotations

import json
import os
import sys
import time

MESHES = ("pod_16x16", "multipod_2x16x16")


def all_cells(archs, shapes) -> list[str]:
    return [f"{a}:{s}:{m}" for m in MESHES for a in archs for s in shapes]


def ref_cells(cells: list[str]) -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from jax.sharding import AxisType

    from repro.configs import ARCHS, SHAPES
    from repro.launch.dryrun import collective_bytes, lower_cell
    from repro.launch.hlo_analysis import HloAnalyzer
    from repro.models import registry
    if cells == ["all"]:
        cells = all_cells(ARCHS, SHAPES)
    out = {}
    for cell in cells:
        arch, shape, mesh_name = cell.split(":")
        cfg, shp = ARCHS[arch], SHAPES[shape]
        ok, reason = registry.supports_shape(cfg, shp)
        if not ok:
            out[cell] = {"status": "SKIP", "reason": reason}
            continue
        multi = mesh_name.startswith("multipod")
        dims = ((2, 16, 16), ("pod", "data", "model")) if multi else \
            ((16, 16), ("data", "model"))
        mesh = jax.make_mesh(*dims, axis_types=(AxisType.Auto,) * len(dims[1]))
        t0 = time.time()
        compiled = lower_cell(cfg, shp, mesh).compile()
        hlo = compiled.as_text()
        a = HloAnalyzer(hlo, mesh.size).analyze(top_k=6)
        mem = compiled.memory_analysis()
        out[cell] = {
            "status": "OK", "seconds": round(time.time() - t0, 2),
            "collective_bytes_per_device": collective_bytes(hlo),
            "hlo_analysis": {k: a[k] for k in (
                "dot_flops", "elem_flops", "bytes", "coll_bytes",
                "coll_bytes_total", "wire_bytes_total", "top_dots",
                "top_collectives")},
            "memory_analysis": {
                k: int(getattr(mem, k)) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes")}}
    return out


def port_cells(cells: list[str]) -> dict:
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import CostRecorder
    if cells == ["all"]:
        cells = all_cells(ARCHS, SHAPES)
    tops = {}
    analyze = CostRecorder.analyze

    def keep_tops(self, top_k=12):      # the record keeps no top lists
        res = analyze(self, top_k)
        tops["last"] = {k: res[k] for k in ("top_dots", "top_collectives")}
        return res

    CostRecorder.analyze = keep_tops
    out = {}
    for cell in cells:
        arch, shape, mesh_name = cell.split(":")
        rec = dryrun.run_cell(arch, shape, mesh_name.startswith("multipod"),
                              out_dir=None, verbose=False)
        if rec["status"] == "OK":
            rec["hlo_analysis"].update(tops.pop("last"))
        out[cell] = rec
    return out


def _ratio(p, r) -> str:
    return f"{p / r:.3f}" if r else "-"


def table(ref: dict, port: dict) -> str:
    """Markdown rows in ``benchmarks/render_tables.dryrun_table``'s
    columns for the port, then the reference's dot FLOPs and collective
    bytes with the port/reference ratio of each, and the port's argument
    bytes against the reference's; one row per (arch, shape), each entry
    "pod / multipod".  Collective bytes are both analyzers' loop-aware
    ``coll_bytes_total`` (the reference's ``collective_bytes`` reads its
    HLO text once, a scan body once).  Skipped cells are listed after."""
    lines = ["| arch | shape | status | compile (s) | dot PFLOPs/dev | "
             "coll GB/dev | HBM args+temp (GiB/dev) | ref dot PFLOPs/dev | "
             "x | ref coll GB/dev | x | args - ref (B) |",
             "|" + "---|" * 12]
    rows: dict = {}
    for cell, p in port.items():
        arch, shape, mesh = cell.split(":")
        rows.setdefault((arch, shape), {})[mesh] = (p, ref.get(cell, {}))
    skipped = []
    for (arch, shape), by_mesh in rows.items():
        pairs = [by_mesh[m] for m in MESHES if m in by_mesh]
        if any(p["status"] != "OK" for p, _ in pairs):
            skipped.append(f"{arch} {shape}")
            continue

        def col(fn):
            return " / ".join(fn(p["hlo_analysis"], r.get("hlo_analysis", {}),
                                 p, r) for p, r in pairs)

        def gib(h, rh, p, r):
            m = p["memory_analysis"]
            return f"{(m['argument_size_in_bytes'] + m['temp_size_in_bytes']) / 2**30:.1f}"

        def args(h, rh, p, r):
            return f"{p['memory_analysis']['argument_size_in_bytes'] - r.get('memory_analysis', {}).get('argument_size_in_bytes', 0):+,}"

        lines.append(" | ".join([
            f"| {arch}", shape, "OK",
            col(lambda h, rh, p, r: f"{p['compile_s']:.0f}"),
            col(lambda h, rh, p, r: f"{h['dot_flops'] / 1e15:.4g}"),
            col(lambda h, rh, p, r: f"{h['coll_bytes_total'] / 1e9:.4g}"),
            col(gib),
            col(lambda h, rh, p, r: f"{rh.get('dot_flops', 0) / 1e15:.4g}"),
            col(lambda h, rh, p, r: _ratio(h["dot_flops"],
                                           rh.get("dot_flops", 0))),
            col(lambda h, rh, p, r:
                f"{rh.get('coll_bytes_total', 0) / 1e9:.4g}"),
            col(lambda h, rh, p, r: _ratio(h["coll_bytes_total"],
                                           rh.get("coll_bytes_total", 0))),
            col(args)]) + " |")
    if skipped:
        lines.append("")
        lines.append("SKIP on both meshes: " + ", ".join(skipped) + ".")
    return "\n".join(lines)


def main(argv: list[str]) -> None:
    mode = argv[0]
    if mode == "table":
        with open(argv[1]) as f:
            ref = json.load(f)
        if os.path.isdir(argv[2]):
            port = {}
            for name in sorted(os.listdir(argv[2])):
                with open(os.path.join(argv[2], name)) as f:
                    rec = json.load(f)
                port[f"{rec['arch']}:{rec['shape']}:{rec['mesh']}"] = rec
            port = {c: port[c] for c in ref if c in port}
        else:
            with open(argv[2]) as f:
                port = json.load(f)
        print(table(ref, port))
        return
    run = {"ref": ref_cells, "port": port_cells}[mode]
    t0 = time.time()
    out = run(argv[2:])
    with open(argv[1], "w") as f:
        json.dump(out, f, indent=1)
    print(f"{len(out)} cells in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main(sys.argv[1:])
