"""Run one cell of the benchmark once on the card and print its result.

    python3 scbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control <name>]

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number compared with
its limit, which are also the last lines of standard error.  A run exits
with 1 and prints no result when there is no card (or fewer than the cell
asks for) or when JAX or the JAX package was loaded.  ``--control`` puts
the reference in the program's place with one guarantee broken; it is for
checking that the comparison rejects it, never for a measurement.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]
# the program builds its kernels under build/ in the checkout; a Triton
# cache, should a kernel come to use one, goes there too, at a fixed path
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(REPO / "build" / "scbench" / "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    import torch
    from scbench import harness

    chips = harness.cell_entry(harness.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"scbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 1
    record, line = harness.run_cell(
        args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda", 0),
        t_start=T_START, control=args.control,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    bad = harness.loaded_forbidden()
    if bad:
        print(f"scbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    line = harness.result_line(record, line,
                               harness.device_info(record, chips))
    for text in harness.checks_text(record):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
