"""The benchmark of ``qchem_rs_tpu_torch``: closed-loop streams of RHF jobs,
one geometry after another, on one card.

    python3 -m hfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix (``hfbench/traffic/<traffic>.json``); each metric is read by
``hfbench/metrics/<name>.py``, or, for a name ``<base>.<cells>`` that has
no file of its own, by ``<base>.py``. A run builds the program at the
configuration, runs one warm-up job (set-up ends there), then starts jobs
until ``--seconds`` have passed and lets the last one finish: that is the
measured window. With ``--trace 1`` three more jobs follow under
``torch.profiler`` with device activity alone (busy time, device
operations; the same three geometries run untraced first give the wall
the busy time is a share of), then three under host and device activity
(what the host did in each idle gap), and the run reports the per-layer metrics instead of
the end-to-end ones. Then the program's state is freed, the window's jobs
are judged against the plain reference (``judge.py``), and the run prints
the numbers compared beside their limits on standard error and one JSON
line on standard output.

Exits 2 without CUDA or with fewer cards than the cell asks for, and 3 if
a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "qchem_rs_tpu"}
TRACED_JOBS = 3


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (``qchem_rs_tpu_torch`` is not ``qchem_rs_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``hfbench/metrics/<name>.py``; where
    there is none and the name has a dotted suffix (one quantity split by
    the end-to-end metric it moves), that of the name without it."""
    path = root / "hfbench" / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        return reader(name.rsplit(".", 1)[0], root)
    spec = importlib.util.spec_from_file_location("hfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def resolve(bench: dict, name: str, root: Path) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic parameters) of workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    return cell, config, json.loads((root / "hfbench" / "traffic" / f"{cell['traffic']}.json").read_text())


def run_job(program, positions):
    """One call of the entry, timed by the host clock around it (the entry
    waits for the device before it returns)."""
    from hfbench.record import Job

    t = time.perf_counter()
    try:
        out = program.run(positions)
    except Exception:  # a job that raises is a failed job; the stream goes on
        return Job(positions, time.perf_counter() - t, error=traceback.format_exc(limit=4))
    return Job(positions, time.perf_counter() - t, out.total_energy(), out.orbital_energies, out.density,
               bool(out.converged), out.iterations + 1, dict(out.timings))


def drive(program, next_geometry, seconds=None, count=None):
    """Jobs at ``next_geometry()`` until ``seconds`` have passed (the last
    job finishes) or ``count`` are done; (jobs, elapsed seconds)."""
    jobs = []
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < seconds) if count is None else len(jobs) < count:
        jobs.append(run_job(program, next_geometry()))
    return jobs, time.perf_counter() - t0


def count_work(config: dict, root: Path, jobs: list, device) -> list[dict]:
    """The counted work (``counts.work``) of each job, from
    the reference's shell pairs and Schwarz factors at its geometry."""
    import torch

    from hfbench.counts import work
    from hfbench.reference.integrals import schwarz, shell_pairs
    from hfbench.reference.molecule import Molecule, read_basis, read_molecule

    numbers, _ = read_molecule(root / config["molecule"])
    basis = read_basis(root / config["basis"])
    thr = config["screening_threshold"]
    out = []
    for job in jobs:
        mol = Molecule(numbers, job.positions, basis)
        batches = shell_pairs(mol, torch.float64, device)
        cls = work.pair_classes(batches, schwarz(batches))
        out.append({"v2_build": work.v2_build(cls, thr), "direct_pass": work.direct_pass(cls, thr, mol.nao),
                    "fock_matvec": work.fock_matvec(mol.nao)})
    return out


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def measure(bench: dict, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            root: Path = ROOT) -> dict:
    """One run of cell ``name`` (its files under ``root``); returns the
    result line as a dict."""
    import torch

    from hfbench import stream, trace as tracing
    from hfbench.judge import judge
    from hfbench.program import Program
    from hfbench.record import Run

    cell, config, traffic = resolve(bench, name, root)
    cuda = torch.device(device).type == "cuda"
    program = Program(config, root, device)

    warm = run_job(program, stream.GeometryStream.of(traffic, config, root, seed, stream.WARMUP).next())
    if warm.error is not None:
        raise RuntimeError(f"the warm-up job failed:\n{warm.error}")
    setup_s = time.perf_counter() - T_START

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    geometries = stream.GeometryStream.of(traffic, config, root, seed, stream.WINDOW)
    jobs, window_s = drive(program, geometries.next, seconds=seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    stages = {"setup": setup_s, "window": window_s}
    traced, summary = [], None
    if trace:
        # the same geometries untraced, then under device activity alone:
        # the kernels' times and the busy time are read from the trace, and
        # the busy share is taken against the untraced wall, which the
        # profiler's own cost on the host does not lengthen
        probe = [geometries.next() for _ in range(TRACED_JOBS)]
        untraced, stages["untraced_jobs"] = drive(program, iter(probe).__next__, count=TRACED_JOBS)
        cpu, gpu = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
        with torch.profiler.profile(activities=[gpu] if cuda else [cpu]) as prof:
            traced, stages["traced_jobs"] = drive(program, iter(probe).__next__, count=TRACED_JOBS)
        summary = tracing.device_summary(prof.profiler.kineto_results.events(), stages["traced_jobs"],
                                         sum(j.wall_s for j in untraced))
        del prof
        # host operations too, only to name what the host did in each
        # idle gap; the profiler slows the host, so nothing else is read
        t = time.perf_counter()
        with torch.profiler.profile(activities=[cpu, gpu] if cuda else [cpu]) as prof:
            with torch.profiler.record_function(tracing.WINDOW):
                drive(program, geometries.next, count=TRACED_JOBS)
        stages["host_traced_jobs"] = time.perf_counter() - t
        summary.idle_gaps = tracing.summarize(prof.profiler.kineto_results.events()).idle_gaps
        del prof
        stages["trace_reading"] = time.perf_counter() - t - stages["host_traced_jobs"]

    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    correct, checks = judge(config, root, jobs, seed, device)
    stages["judge"] = time.perf_counter() - t
    work = {}
    if trace:
        t = time.perf_counter()
        work = {"jobs": count_work(config, root, jobs, device), "traced": count_work(config, root, traced, device)}
        stages["counts"] = time.perf_counter() - t

    run = Run(cell, config, setup_s, window_s, jobs, peak, traced, summary, work)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if applies(m, cell):
            value = reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": len(jobs),
              "failed": sum(j.error is not None or not j.converged for j in jobs),
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = summary.breakdown()
    result["stages_s"] = stages
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(HERE / "_cache" / sub)
    # one host thread for every library, set before numpy and torch load:
    # the in-core cell's host layers then vary by ~1% between windows, not
    # ~7% as with a thread per core on a host shared with other machines
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    import torch

    torch.set_num_threads(1)

    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hfbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = measure(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"hfbench: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, sec in result["stages_s"].items():
        print(f"stage {name} {sec:.3f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
