"""The readings a cell's limits are set from, in one process on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 1]

For every seed: one run of the cell (``run.run_cell``) with a short
window at the cell's own load and sizes, and the program's readings of
the comparison (the lower readings). For each control seed also the
control's: the reference computed in fp8 put in the program's place (the
upper readings; ``reference/lowp.py``). One JSON line a seed. The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.run import run_cell  # noqa: E402


def readings(workload: str, seed: int, seconds: float, control: bool,
             **kw) -> dict:
    """The program's readings of one run, and the fp8 control's where
    ``control``; ``kw`` passes to ``run_cell`` (tests: device, sizes)."""
    t0 = time.perf_counter()
    r = run_cell(workload, seed, seconds, False, t0=t0,
                 control="fp8" if control else None, **kw)
    out = {"seed": seed, "correct": r["correct"],
           "program": {k: v["value"] for k, v in r["checks"].items()},
           "control": r.get("control"),
           "seconds": time.perf_counter() - t0}
    del r
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  seed in controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
