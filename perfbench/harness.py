"""The benchmark's core: find a cell's files by name, build the port's
system for it, run jobs back to back for the measured window, read the
metrics, check the outputs against the plain reference and print the
result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes;
- ``perfbench/traffic/<traffic>.json``: the mix, read by ``traffic.py``
  and run by ``drivers/<path>.py`` (``path`` is a key of the mix);
- ``perfbench/metrics/<metric>.py``: one reader a metric, ``read(run)``,
  which returns None where it finds nothing to read;
- ``perfbench/limits/<workload>.json``: the limits of the comparison.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# whole top-level module names no run may load (the JAX package is
# ``repro``; the port's own name, ``repro_torch``, only begins with it)
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def banned_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A file of the benchmark as a module (metric file names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _in_cell(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def load_cell(name: str, spec: Optional[dict] = None, *,
              config_over: Optional[dict] = None,
              traffic_over: Optional[dict] = None,
              limits_over: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read; the
    overrides replace keys (tests run a cell at a small size)."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = dict(load_json(ROOT / cfg_entry["file"]), **(config_over or {}))
    traffic = dict(load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                   **(traffic_over or {}))
    limits_path = BENCH / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    limits.update(limits_over or {})
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _in_cell(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _in_cell(m, name)])


def port_config(config: dict):
    """The port's ``ModelConfig`` as the configuration file states it:
    its ``port`` section, with each size taken from the source key that
    ``port_sizes`` names."""
    from repro_torch.models.common import LayerSpec, ModelConfig
    kw = dict(config["port"])
    kw["pattern"] = tuple(LayerSpec(*p) for p in kw["pattern"])
    for field, key in config["port_sizes"].items():
        kw[field] = config[key]
    return ModelConfig(**kw)


# ---------------------------------------------------------------------------
# Host spans and counters around calls into the program
# ---------------------------------------------------------------------------


class Probes:
    """Host-clock spans (name, start ns, end ns, job) and counters, taken
    by wrappers this benchmark puts around the program's entry points.
    A wrapper is installed only where its target exists, so a program
    that moved an entry point leaves the metrics that read it silent."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.counts: Dict[tuple, int] = {}
        self.calls: Dict[str, List[tuple]] = {}
        self.job: Optional[int] = None
        self._undo: List[tuple] = []

    def count(self, name: str, n: int = 1) -> None:
        key = (name, self.job)
        self.counts[key] = self.counts.get(key, 0) + n

    def wrap(self, owner, attr: str, label: str, *, rows=None,
             keep=None) -> bool:
        """Time every call of ``owner.attr`` as a span ``label``;
        ``rows(args, kwargs)`` adds to the counter ``label + '_rows'`` and
        ``keep(args, kwargs, out)`` sees each result."""
        orig = getattr(owner, attr, None)
        if orig is None:
            return False

        def timed(*args, **kwargs):
            t0 = time.perf_counter_ns()
            out = orig(*args, **kwargs)
            self.spans.append((label, t0, time.perf_counter_ns(), self.job))
            if rows is not None:
                self.count(label + "_rows", rows(args, kwargs))
            if keep is not None:
                keep(args, kwargs, out)
            return out
        self._undo.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, timed)
        return True

    def record(self, owner, attr: str, label: str, shape) -> bool:
        """Record ``shape(args, kwargs)`` of every call of ``owner.attr``
        (a kernel entry) under ``label``, with the job it ran in."""
        orig = getattr(owner, attr, None)
        if orig is None:
            return False
        calls = self.calls.setdefault(label, [])

        def recorded(*args, **kwargs):
            calls.append((self.job,) + tuple(shape(args, kwargs)))
            return orig(*args, **kwargs)
        self._undo.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, recorded)
        return True

    def span(self, label: str, t0: int, t1: int) -> None:
        self.spans.append((label, t0, t1, self.job))

    def close(self) -> None:
        """Put every wrapped attribute back."""
        for owner, attr, old in reversed(self._undo):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._undo.clear()


@dataclasses.dataclass
class Job:
    index: int
    t0: int                # host ns at its start
    t1: int                # host ns at its end
    items: int
    tokens: int            # generated tokens (0 for a classifier)
    missing: int           # items of the job with no (whole) answer
    out: Any = None        # what the driver keeps for the comparison


class Run:
    """One run of one cell: the arguments, the chosen device, the made
    weights, the probes and the jobs the window ran."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.config, self.traffic = cell.config, cell.traffic
        self.probes = Probes()
        self.driver = None
        self.weights = None
        self.setup_s = 0.0
        self.jobs: List[Job] = []
        self.window_t0 = 0
        self.counted: List[Job] = []
        self.summary: Dict[str, Any] = {}

    def log(self, msg: str) -> None:
        print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def run_window(run: Run, driver, tracer, k0: int = 0) -> None:
    """Jobs back to back from the window's start, numbered from ``k0``. A
    job that starts before ``seconds`` have passed runs to its end; the
    window's jobs are those that ended within ``seconds`` (at least the
    first). ``run.jobs`` and ``run.counted`` hold this window's."""
    sync(run.device)
    tracer.mark()
    run.jobs = []
    run.window_t0 = t0 = time.perf_counter_ns()
    limit = t0 + int(run.seconds * 1e9)
    k = k0
    while time.perf_counter_ns() < limit:
        run.probes.job = k
        start = time.perf_counter_ns()
        job = driver.job(k)
        sync(run.device)
        job.t0, job.t1 = start, time.perf_counter_ns()
        run.probes.span("job", job.t0, job.t1)
        tracer.mark()
        run.jobs.append(job)
        k += 1
    run.probes.job = None
    run.counted = [j for j in run.jobs if j.t1 <= limit] or run.jobs[:1]


def window_s(run: Run) -> float:
    """Seconds from the window's start to the end of its last job."""
    return (run.counted[-1].t1 - run.window_t0) / 1e9


def span_seconds(run: Run) -> Dict[str, float]:
    """Host seconds in each kind of span over the window's counted jobs."""
    keep = {j.index for j in run.counted}
    out: Dict[str, float] = {}
    for name, t0, t1, job in run.probes.spans:
        if job in keep:
            out[name] = round(out.get(name, 0.0) + (t1 - t0) / 1e9, 3)
    return out


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or where that is absent the reader of the
    name before its first dot (``mfu_pct.dag`` reads as ``mfu_pct``: a
    split name exists only for its own ``moves``)."""
    path = BENCH / "metrics" / f"{name}.py"
    return path if path.exists() else BENCH / "metrics" / (
        name.split(".")[0] + ".py")


def read_metrics(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = load_module(reader_path(m["name"])).read(run)
        if value is None:
            run.log(f"metric {m['name']}: nothing to read, left out")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(readings: Dict[str, Optional[float]], limits: dict):
    """(correct, checks): every number compared beside its limit; a
    number with no reading or no limit set is not correct."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name, {}).get("limit")
        good = value is not None and limit is not None and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
