"""Readings that the limits of ``judge.py`` are set from, at a cell's own
size: the program's gaps to the reference on many seeds (the lower
reading), and the control's, the reference itself computed in float32 and
put in the program's place, on a few (the upper reading).

    python3 -m hfbench.control --workload <cell> --seeds 11 12 ... --control-seeds 11 12 13

For each seed it takes the first ``--jobs`` geometries of the cell's
measured stream, judges the program's result there, and, for a control
seed, the float32 reference's, both against one float64 reference. One
JSON line per geometry on standard output. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    import torch

    from hfbench import run, stream
    from hfbench.judge import reference_at
    from hfbench.program import Program

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic = run.resolve(bench, args.workload, run.ROOT)
    program = Program(config, run.ROOT, args.device)
    run.run_job(program, stream.GeometryStream.of(traffic, config, run.ROOT, args.seeds[0], stream.WARMUP).next())
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        geometries = stream.GeometryStream.of(traffic, config, run.ROOT, seed, stream.WINDOW)
        jobs, _ = run.drive(program, geometries.next, count=args.jobs)
        for k, job in enumerate(jobs):
            ref = reference_at(config, run.ROOT, job.positions, torch.float64, args.device)
            sol = ref.solve()
            line = {"workload": args.workload, "seed": seed, "job": k, "reference_converged": sol.converged,
                    "reference_iterations": sol.iterations}
            if seed in args.seeds:
                line["program"] = ref.judge(sol, job.energy, job.orbital_energies, job.density) | {
                    "converged": job.converged, "passes": job.passes, "wall_s": job.wall_s}
            if seed in args.control_seeds:
                low = reference_at(config, run.ROOT, job.positions, torch.float32, args.device).solve()
                line["control"] = ref.judge(sol, low.energy, low.orbital_energies, low.density) | {
                    "converged": low.converged, "iterations": low.iterations}
            print(json.dumps(line), flush=True)
            del ref
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
