"""Run one cell of the port's benchmark on the card it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout (``src/repro_torch`` and ``BENCHMARK.json``
beside ``perfbench/``). A run:

1. exits with 2, printing no result, without a CUDA device or with fewer
   than the cell asks for;
2. sets up (counted in ``setup_s``, from process start): imports, the
   weights drawn on the card from ``--seed``, the port's system for the
   cell's path (``perfbench/drivers/<path>.py``), kernels built into the
   checkout's ``build/kernels`` at first use, a warm-up job of the cell's
   own shapes;
3. runs the cell's jobs back to back for ``--seconds``; with ``--trace 1``
   reads the per-layer metrics of host clocks and counters there, then
   runs a second window as long under ``torch.profiler`` for those of the
   device trace;
4. reads the peak device memory, frees the program's state, and holds
   what the windows produced to the plain reference
   (``perfbench/reference``) by the limits in
   ``perfbench/limits/<cell>.json``;
5. exits with 3, printing no result, if a module whose whole top-level
   name is ``jax``, ``jaxlib``, ``flax``, ``repro`` or ``benchmarks`` is
   loaded;
6. prints each number compared beside its limit as its last lines on
   standard error, and as its last line on standard output one JSON
   object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
   end-to-end metrics with ``--trace 0``, its per-layer metrics with
   ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
   ``checks``.
"""
from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402
from perfbench.trace import Tracer, top  # noqa: E402


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", require_chip: bool = True,
             config_over=None, traffic_over=None, limits_over=None,
             t0: float = None, control: str = None) -> dict:
    """One run of ``workload``; returns the result line as a dict (with
    ``"lines"``, the stderr lines of the comparison). Tests call it on the
    CPU at a small size with ``require_chip=False`` and overrides;
    ``control`` names a lower precision whose reference is read in the
    program's place beside the program's readings (``control.py``)."""
    t0 = PROCESS_T0 if t0 is None else t0
    cell = harness.load_cell(workload, config_over=config_over,
                             traffic_over=traffic_over,
                             limits_over=limits_over)
    import torch
    if require_chip:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark measures the "
                             "card and has no CPU fallback")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{workload} needs {cell.chips} CUDA devices, "
                             f"found {torch.cuda.device_count()}")
    run = harness.Run(cell, seed, seconds, trace, device)
    driver_mod = harness.load_module(
        harness.BENCH / "drivers" / f"{cell.traffic['path']}.py")
    t_drv = time.perf_counter()
    driver = driver_mod.Driver(run)
    run.driver = driver
    harness.sync(device)
    run.log(f"set-up: imports {t_drv - t0:.3f} s, weights, system and "
            f"warm-up {time.perf_counter() - t_drv:.3f} s")
    setup_s = time.perf_counter() - t0
    harness.run_window(run, driver, Tracer(False))
    _log_window(run, "window")
    run.setup_s = setup_s
    ran = list(run.jobs)
    if not trace:
        metrics = harness.read_metrics(run, cell.end_to_end)
        jobs = run.counted
    else:
        # host clocks and counters from this untraced window; the device
        # trace from a second window of the same length under the profiler
        # (whose CUPTI slows a host-bound job)
        host = [m for m in cell.per_layer if m["source"] != "device_trace"]
        metrics = harness.read_metrics(run, host)
        jobs, tracer = list(run.counted), Tracer(True)
        tracer.start()
        harness.run_window(run, driver, tracer, k0=run.jobs[-1].index + 1)
        tracer.stop()
        _log_window(run, "traced window")
        t_read = time.perf_counter()
        run.summary = tracer.read(len(run.counted), run.probes.spans) or {}
        run.log(f"trace read in {time.perf_counter() - t_read:.3f} s")
        dev = harness.read_metrics(run, [m for m in cell.per_layer
                                         if m not in host])
        metrics = {m["name"]: (metrics.get(m["name"]) or dev.get(m["name"]))
                   for m in cell.per_layer}
        metrics = {k: v for k, v in metrics.items() if v is not None}
        jobs += run.counted
        ran += run.jobs
    cuda = device.startswith("cuda")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.probes.close()
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    run.counted = jobs
    readings = driver.compare()
    readings["missing"] = float(sum(j.missing for j in jobs))
    correct, checks = harness.judge(readings, cell.limits)
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}"
             for k, v in checks.items()]
    result = {"correct": correct,
              "attempted": sum(j.items for j in ran),
              "failed": sum(j.missing for j in ran),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name()
                                  if cuda else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if control:
        low = driver.compare(control)
        result["control"] = {k: v for k, v in low.items()}
        lines += [f"control {control} {k} {v!r}" for k, v in low.items()]
    run.log(f"comparison in {time.perf_counter() - t_ref:.3f} s")
    if trace and run.summary:
        result["device"]["busy_s"] = run.summary["busy_s"]
        result["device"]["window_s"] = run.summary["window_s"]
        result["breakdown"] = {
            "device_ops": top(run.summary["by_name"]),
            "idle_gaps": top(run.summary["idle_by_span"])}
    result["checks"] = checks
    result["lines"] = lines
    return result


def _log_window(run, what: str) -> None:
    run.log(f"{what}: {len(run.counted)} of {len(run.jobs)} jobs within "
            f"{run.seconds} s, {harness.window_s(run):.3f} s to the last; "
            f"jobs {[round((j.t1 - j.t0) / 1e9, 3) for j in run.jobs]} s; "
            f"host s in calls {harness.span_seconds(run)}")


def _power() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except SystemExit as e:
        print(f"[perfbench] {e}", file=sys.stderr)
        return 2
    banned = harness.banned_modules()
    if banned:
        print(f"[perfbench] loaded modules the benchmark must not load: "
              f"{banned}", file=sys.stderr)
        return 3
    print(f"[perfbench] card: {_power()}", file=sys.stderr)
    for line in result.pop("lines"):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
