"""The benchmark of the hand tracker's PyTorch and CUDA port.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs the cell of ``BENCHMARK.json``
named by ``--workload`` on one card: set-up, then ``--seconds`` of the
cell's traffic, then (``--trace 1``) a few frames under the profiler,
then the check of the window's answers against the plain reference.
The last line of standard output is the result as one JSON object; the
last lines of standard error are the compared numbers beside their
limits.  It exits 2, with no result, where the card or a file is
missing, and 3 where a module of the JAX reference is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "src"):  # this package, and the program under test
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from chipbench import harness, manifest

    try:
        cell = manifest.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as exc:
        harness.log(f"cannot read the cell {args.workload!r}: {exc}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"the cell asks for {cell.chips} CUDA card(s); this host has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        harness.resolve(cell.config["entry"]["step"])
    except ImportError as exc:
        harness.log(f"cannot import the program: {exc}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"the process holds {loaded}: the JAX reference may not run here")
        return 3
    for name, c in result["compared"].items():
        harness.log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
