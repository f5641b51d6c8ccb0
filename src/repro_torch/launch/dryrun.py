"""Compile-only dry run: trace one rank's program of every (arch x shape x
mesh) cell on the production mesh, with no card.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 placeholder devices. PyTorch runs one process a rank and
compiles nothing ahead of time, so here ONE process plays one rank
(``--rank``, default 0) of ``launch.mesh.make_production_mesh``'s 256 or
512 ranks under torch's ``"fake"`` process-group backend, and runs that
rank's program on fake tensors (``FakeTensorMode``, device type CPU: no
memory is allocated, nothing is computed, and autograd's backward runs
here, which fake CUDA tensors do not allow on a CPU-only build). The
card is never touched: after a cell ``torch.cuda.is_initialized()`` is
still False.

Per cell this script:
  1. builds the model from its full production config and plans the
     rank's layout (``dist.sharding.pick_strategy``, with the reference's
     fall-back to "fsdp_tp" when the global batch does not divide over
     every rank),
  2. makes the rank's params (``Model.abstract``), optimizer state and
     the cell's inputs (``Model.input_specs``) as fake tensors,
  3. runs what a rank runs: one train step (``make_train_step``, rows
     cut over the batch axes), one prefill or one decode step
     (``serving.Engine``'s bucket functions, rows cut over the data
     axes), on the reference's own dry-run paths (``attn_impl="xla"``;
     decode ``"seq_shard"`` with the plain partials), under
     ``launch.hlo_analysis.AnalysisMode``,
  4. records the rank's memory, its op-stream analysis (FLOPs, HBM
     bytes, collectives by type and link, peak live bytes, layers
     traced) and the roofline terms against the H100 SXM data sheet,
  5. writes a JSON record to ``artifacts/dryrun_torch/``.

A cell that cannot be traced is recorded as ``status: "error"`` with its
traceback; an inapplicable one (``model_zoo.shape_applicable``) as
``"skip"``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod both|on|off]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.dist import collectives
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.models import RunConfig, SkipCell, build
from repro_torch.models.common import param_bytes
from repro_torch.models.model_zoo import SHAPES
from repro_torch.serving.engine import Engine
from repro_torch.training.optimizer import Adafactor, AdamW, constant
from repro_torch.training.train_step import make_train_step
from repro_torch.tree import tree_leaves

# NVIDIA H100 SXM data sheet (dense bf16, HBM3, NVLink 4, one 400 Gb/s NIC
# a GPU as in a DGX H100): the roofline's constants, not measurements
PEAK_FLOPS = 989e12        # bf16 FLOP/s a card
HBM_BW = 3.35e12           # bytes/s a card
NVLINK_BW = 450e9          # bytes/s each way, a line within one host
NETWORK_BW = 50e9          # bytes/s, a line that crosses hosts
HOST_CARDS = 8             # cards a host (consecutive ranks)
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
ADAFACTOR_ABOVE = 200e9    # param bytes past which train takes Adafactor


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as ``rank`` of ``world_size`` under the ``"fake"``
    process-group backend (collectives return at once, moving nothing),
    torn down on exit."""
    # importing the store registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: a "
                           "process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def default_run(kind: str, cfg, strategy: str,
                overrides: Optional[dict] = None) -> RunConfig:
    """The reference's per-kind knobs: train "full" remat without
    microbatches under "fsdp", "dots" remat in microbatches of 32
    otherwise; prefill with sequence parallelism off MoE and SSM models;
    decode "seq_shard" on attention models. Attention is the plain path
    ("xla") everywhere, as the reference's dry run lowers it."""
    if kind == "train":
        if strategy == "fsdp":
            run = RunConfig(attn_impl="xla", moe_impl="auto", remat="full",
                            microbatch=None)
        else:
            run = RunConfig(attn_impl="xla", moe_impl="auto", remat="dots",
                            microbatch=32)
    elif kind == "prefill":
        run = RunConfig(attn_impl="xla", moe_impl="auto",
                        seq_parallel=(cfg.moe is None
                                      and not cfg.attention_free))
    else:  # decode
        run = RunConfig(attn_impl="seq_shard" if not cfg.attention_free
                        else "xla", moe_impl="auto")
    if overrides:
        run = dataclasses.replace(run, **overrides)
    return run


def model_flops_analytic(model, shape: str) -> float:
    """6·N·D (train) / 2·N·D (inference), N = active params, D = tokens."""
    seq, gb, kind = SHAPES[shape]
    n = model.active_param_count
    tokens = gb * seq if kind != "decode" else gb * 1
    return (6.0 if kind == "train" else 2.0) * n * tokens


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def _counting_layers(seen: set):
    """Record in ``seen`` each layer unit the traced program makes ready
    (``collectives.gathered`` at the head of every layer)."""
    real = collectives.gathered

    def spy(sub, *path):
        if path and path[0] in ("blocks", "enc_blocks", "dec_blocks"):
            seen.add(path[:2])
        return real(sub, *path)
    collectives.gathered = spy
    try:
        yield
    finally:
        collectives.gathered = real


def _fake(t: torch.Tensor) -> torch.Tensor:
    """Zeros of ``t``'s shape and dtype on the CPU: fake under the cell's
    ``FakeTensorMode``, valid token ids on real ranks."""
    return torch.zeros(t.shape, dtype=t.dtype)


def build_step(model, kind: str, run: RunConfig, mesh, strategy: str,
               inputs, cache):
    """(fn, memory, held) for one rank: ``fn()`` runs the rank's step on
    its tensors, ``memory`` holds their bytes by kind and ``held`` the
    tensors. Under a ``FakeTensorMode`` they are fake and nothing runs;
    outside it the step runs for real (on a real mesh's ranks, the
    collectives counted in ``dist.collectives.STATS``). ``inputs`` are
    the whole batch's (meta tensors of ``Model.input_specs``); the step
    cuts the rank's rows. ``mesh`` None: one device, no layout."""
    inputs = {k: _fake(v) for k, v in inputs.items()}
    batch_rows = next(iter(inputs.values())).shape[0]
    if kind == "train":
        shardings = (None if mesh is None else
                     shd.param_shardings(model.param_specs, strategy, mesh))
        params = model.abstract(shardings)
        opt = (Adafactor(schedule=constant(1e-4))
               if param_bytes(model.param_specs) > ADAFACTOR_ABOVE
               else AdamW(schedule=constant(1e-4)))
        state = opt.init(params)
        step = make_train_step(model, run, opt, mesh=mesh, strategy=strategy)
        axes = (dctx.fsdp_batch_axes(mesh) if strategy == "fsdp"
                else dctx.dp_axes(mesh))
        rows = math.prod(dctx.axis_size(a, mesh) for a in axes)
        memory = {"param_bytes": _nbytes(params),
                  "optimizer_bytes": _nbytes(state),
                  "input_bytes": _nbytes(inputs) // rows,
                  "cache_bytes": 0}
        return (lambda: step(params, state, inputs)), memory, (
            params, state, inputs)
    engine = Engine(model, run, device="cpu", mesh=mesh, strategy=strategy,
                    seq_shard=run.attn_impl == "seq_shard")
    params = model.abstract(engine.params_sharding)
    n_rows = engine._rows(next(iter(inputs.values())))[0]
    memory = {"param_bytes": _nbytes(params), "optimizer_bytes": 0,
              "input_bytes": _nbytes(inputs) // n_rows}
    if kind == "prefill":
        seq = next(iter(inputs.values())).shape[1]
        # the engine's prefill bucket: rows cut over the data axes, the
        # logits gathered, the rank's cache kept
        fn = engine._prefill_fn(seq + run.cache_pad)
        memory["cache_bytes"] = 0

        def prefill():
            with engine._ctx(), torch.no_grad():
                return fn(params, inputs)
        return prefill, memory, (params, inputs)
    # decode: this rank's slice of the whole cache, as the engine lays it
    # out (an attention-free cache has no position-sized leaf)
    enc_len = cache.cross_k[0].shape[1] if hasattr(cache, "cross_k") \
        else None
    local = engine.new_cache(batch_rows, cache.kv_capacity() or 1,
                             enc_len=enc_len)
    memory["cache_bytes"] = _nbytes(local.tensors())
    token = inputs["token"]
    return (lambda: engine.decode(params, local, token)), memory, (
        params, local, inputs)


def trace_step(model, kind: str, run: RunConfig, mesh, strategy: str,
               inputs, cache=None):
    """Trace one rank's step of ``kind`` on ``mesh`` (whose process groups
    may be the ``"fake"`` backend's, or real ones) under a fresh
    ``FakeTensorMode``: (``hlo_analysis.Analysis``, memory by kind,
    layers traced, seconds)."""
    an = hlo_analysis.Analysis()
    layers: set = set()
    t0 = time.perf_counter()
    with FakeTensorMode(), dctx.batch_axes(
            dctx.fsdp_batch_axes(mesh) if strategy == "fsdp" else None):
        fn, memory, held = build_step(model, kind, run, mesh, strategy,
                                      inputs, cache)
        with _counting_layers(layers), hlo_analysis.AnalysisMode(
                an, track=held, host_cards=HOST_CARDS):
            out = fn()
        del out, fn, held
    return an, memory, len(layers), time.perf_counter() - t0


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             run_overrides: Optional[dict] = None,
             strategy: Optional[str] = None, tag: str = "",
             verbose: bool = True, rank: int = 0) -> dict:
    cfg = configs.get(arch)
    model = build(cfg)
    seq, gb, kind = SHAPES[shape]
    with fake_world(512 if multi_pod else 256, rank):
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = n_chips(mesh)
        rec = {
            "arch": arch, "shape": shape, "multi_pod": multi_pod,
            "chips": chips, "rank": rank, "tag": tag,
            "params": model.n_params,
            "active_params": model.active_param_count,
            "seq_len": seq, "global_batch": gb, "kind": kind,
        }
        try:
            strat = strategy or shd.pick_strategy(model.param_specs, mesh,
                                                  kind)
            if strat == "fsdp" and gb % chips != 0:
                # pure FSDP cuts the rows over every rank; with fewer rows
                # than ranks fall back to ZeRO-3 + TP, as the reference
                strat = "fsdp_tp"
            run = default_run(kind, cfg, strat, run_overrides)
            kind, inputs, cache = model.input_specs(shape, run)
            rec["strategy"] = strat
            rec["run"] = dataclasses.asdict(run)
            collectives.set_fused_partials(False)
            try:
                an, memory, layers, secs = trace_step(
                    model, kind, run, mesh, strat, inputs, cache)
            finally:
                collectives.set_fused_partials(None)
            rec["trace_s"] = round(secs, 2)
            memory["peak_live_bytes"] = int(an.peak_live_bytes)
            memory["fits_80g_hbm"] = bool(
                an.peak_live_bytes <= shd.HBM_BYTES)
            rec["memory"] = memory
            coll_s = sum(b / LINK_BW[link]
                         for link, b in an.collective_by_link.items())
            rec["ops"] = {
                "flops_per_chip": an.flops,
                "hbm_bytes_per_chip": an.hbm_bytes,
                "collective_bytes_per_chip": an.total_collective_bytes,
                "collective_by_type": dict(an.collective_bytes),
                "collective_instances": dict(an.collective_instances),
                "collective_by_link": dict(an.collective_by_link),
                "layers_traced": layers,
                "n_dots": an.n_dots,
                "hbm_top": an.hbm_top(),
            }
            compute_s = an.flops / PEAK_FLOPS
            memory_s = an.hbm_bytes / HBM_BW
            dominant = max((compute_s, "compute"), (memory_s, "memory"),
                           (coll_s, "collective"))[1]
            mf = model_flops_analytic(model, shape)
            rec["roofline"] = {
                "constants": "NVIDIA H100 SXM data sheet, not measured",
                "compute_s": compute_s,
                "memory_s": memory_s,
                "collective_s": coll_s,
                "dominant": dominant,
                "bound_s": max(compute_s, memory_s, coll_s),
                "roofline_fraction": compute_s / max(compute_s, memory_s,
                                                     coll_s, 1e-30),
                "model_flops_total": mf,
                "model_flops_per_chip": mf / chips,
                "useful_flops_ratio": (mf / chips) / max(an.flops, 1e-30),
            }
            rec["status"] = "ok"
            if verbose:
                r = rec["roofline"]
                print(f"[ok] {arch:24s} {shape:12s} pod={int(multi_pod)+1} "
                      f"{strat:8s} trace={rec['trace_s']:6.1f}s "
                      f"C={r['compute_s']*1e3:9.2f}ms "
                      f"M={r['memory_s']*1e3:9.2f}ms "
                      f"X={r['collective_s']*1e3:9.2f}ms -> {r['dominant']}"
                      f" useful={r['useful_flops_ratio']:.3f}", flush=True)
        except SkipCell as e:
            rec["status"] = "skip"
            rec["skip_reason"] = str(e)
            if verbose:
                print(f"[skip] {arch:24s} {shape:12s}: {e}", flush=True)
        except Exception as e:  # a failure here is a bug in the port
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
            if verbose:
                print(f"[ERR] {arch:24s} {shape:12s}: {type(e).__name__}: "
                      f"{str(e)[:200]}", flush=True)
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    return rec


def save_artifact(rec: dict, out_dir: str = ARTIFACT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    pod = "pod2" if rec["multi_pod"] else "pod1"
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{pod}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="off", choices=["off", "on",
                                                           "both"])
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production mesh this process "
                         "plays")
    args = ap.parse_args(argv)

    overrides = {}
    for k, v in [("attn_impl", args.attn_impl), ("moe_impl", args.moe_impl),
                 ("remat", args.remat), ("microbatch", args.microbatch)]:
        if v is not None:
            overrides[k] = v

    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    archs = configs.ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    n_ok = n_skip = n_err = 0
    for multi_pod in pods:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi_pod=multi_pod,
                               run_overrides=overrides or None,
                               strategy=args.strategy, tag=args.tag,
                               rank=args.rank)
                save_artifact(rec, args.out)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skip"
                n_err += rec["status"] == "error"
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skip, {n_err} error")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
