"""The readings that the limits of the correctness check are set from.

    python3 chipbench/readings.py --workload <cell> --seeds 11,12,... \
        --seconds 4 --control-seeds 21,22,23 --truncated-seeds 31,32,33 \
        [--truncated-generations 20] [--out readings.jsonl]

In one process, so that set-up is paid once: the program's step on each
of ``--seeds`` (a short window at the cell's own load, then the check on
as many sampled frames as a run compares); then the control (the
reference in bfloat16 in the program's place, ``chipbench.control``) on
each of ``--control-seeds``; then the program's search cut short to its
first ``--truncated-generations`` generations
(``harness.truncated_step``) on each of ``--truncated-seeds``.  Prints
one JSON line a seed with the compared numbers, and for each kind the
program's highest and the stand-ins' lowest: a limit lies above the one
and below the other.  The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--truncated-seeds", default="")
    parser.add_argument("--truncated-generations", type=int, default=20)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from chipbench import harness, manifest
    from chipbench.control import ControlStep

    cell = manifest.load_cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    frame_cfg = cell.model.frame_config(cell.config)
    program = harness.build_step(cell.config, device)
    stand_ins = {"program": (args.seeds, lambda: program),
                 "control": (args.control_seeds,
                             lambda: ControlStep(cell.model, frame_cfg, device)),
                 "truncated": (args.truncated_seeds, lambda: harness.truncated_step(
                     cell.config, device, args.truncated_generations))}
    runs = []
    for who, (seeds, make) in stand_ins.items():
        seeds = [int(s) for s in seeds.split(",") if s]
        if seeds:
            step = make()
            runs += [(who, seed, step) for seed in seeds]
    lines = []
    for who, seed, step in runs:
        t = time.perf_counter()
        ctx, metrics, _, _, (depth, _, pool) = harness.measure(
            cell, step, frame_cfg, seed, args.seconds, False, device, t)
        values, ok, _ = harness.judge_run(cell, frame_cfg, ctx.frames, depth, pool, seed, device)
        line = {"cell": cell.name, "who": who, "seed": seed, "frames": len(ctx.frames),
                "within_limits": ok, "values": values,
                "metrics": {k: v["value"] for k, v in metrics.items()},
                "seconds": time.perf_counter() - t}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    for who in stand_ins:
        mine = [line["values"] for line in lines if line["who"] == who]
        if mine:
            pick = max if who == "program" else min
            print(json.dumps({"cell": cell.name, "who": who, "seeds": len(mine),
                              "reading": {k: pick(v[k] for v in mine) for k in mine[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
