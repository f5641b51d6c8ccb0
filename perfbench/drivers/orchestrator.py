"""The paper's job: a classifier over a corpus, through the serverless
orchestrator (``core.Orchestrator.run`` over ``ServerlessFunction.invoke``
-> ``Engine.classify``), as ``launch.serve.run_offline`` runs its parallel
half.

Set-up publishes the benchmark's weights to the artifact store and runs
``warmup_jobs`` whole jobs, which cold-start every function: the
functions then stay warm across the window's jobs, as a platform keeps
containers warm between back-to-back jobs. Each invocation is timed on
CUDA events around ``invoke`` (its real duration; the orchestrator's
modeled constants are not card time). The comparison takes a sample of
the window's items, drawn from the seed, and holds the labels the jobs
merged and the logits ``Engine.classify_logits`` returned for them to
``reference/encoder.py``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import flops
from perfbench.harness import Job, Run, port_config
from perfbench.reference.encoder import encoder_logits
from perfbench.reference.lowp import Precision
from perfbench.traffic import Corpus
from perfbench.weights import make_weights


class Driver:
    def __init__(self, run: Run):
        from repro_torch.core import (ArtifactStore, LatencyModel,
                                      ServerlessFunction)
        from repro_torch.models import RunConfig, build
        from repro_torch.serving import Engine

        self.run = run
        mix = run.traffic
        self.mcfg = port_config(run.config)
        model = build(self.mcfg)
        self.engine = Engine(model, RunConfig(attn_impl="pallas"),
                             device=run.device)
        run.weights = make_weights(model.param_specs, run.config["init"],
                                   run.seed, run.device)
        self.store = ArtifactStore()
        self.store.put_tree("models/clf", run.weights)
        self.corpus = Corpus(mix, self.mcfg.vocab_size, run.seed)
        self.logits = {}            # (job, first item) -> (B, L) logits
        self.timings = []           # (job, start event, end event)
        self.current = None
        probes = run.probes

        def keep(args, kwargs, out):
            self.logits[self.current] = out
        probes.wrap(self.engine, "classify_logits", "classify", keep=keep)
        from repro_torch.kernels.flash_attention import ops as fa_ops
        probes.record(fa_ops, "flash_attention", "flash", flops.flash_call)
        lat = LatencyModel(cold_start_s=mix["cold_start_s"])
        cuda = run.device.startswith("cuda")
        driver = self

        class Timed(ServerlessFunction):
            def invoke(self, job, chunk, data=None):
                driver.current = (probes.job, chunk.start)
                t0 = torch.cuda.Event(enable_timing=True) if cuda else None
                if cuda:
                    t0.record()
                h0 = time.perf_counter_ns()
                out = super().invoke(job, chunk, data)
                h1 = time.perf_counter_ns()
                if cuda:
                    t1 = torch.cuda.Event(enable_timing=True)
                    t1.record()
                    driver.timings.append((probes.job, t0, t1))
                else:
                    driver.timings.append((probes.job, (h1 - h0) / 1e6))
                probes.span("invoke", h0, h1)
                return out

        self.workers = {}

        def make_worker(wid):
            if wid not in self.workers:
                self.workers[wid] = Timed(wid, self.store, lat,
                                          engine=self.engine,
                                          params_ref="models/clf")
            return self.workers[wid]
        self.make_worker = make_worker
        for k in range(mix["warmup_jobs"]):
            self.job(-1 - k)
        self.logits.clear()
        self.timings.clear()

    def job(self, k: int) -> Job:
        from repro_torch.core import (BatchJob, FaultInjector, Orchestrator,
                                      OrchestratorConfig, decompose, merge)
        from repro_torch.data.pipeline import DatasetRef
        mix, run = self.run.traffic, self.run
        tokens = self.corpus.job(k)
        n, s = tokens.shape
        job = BatchJob(f"job{k}", DatasetRef("imdb", n, s,
                                             self.mcfg.vocab_size),
                       "models/clf", mix["chunk_items"])
        chunks = decompose(job)
        orch = Orchestrator(
            self.store,
            OrchestratorConfig(max_concurrency=mix["max_concurrency"],
                               retry_max_attempts=mix["retry_max_attempts"],
                               speculation_factor=mix["speculation_factor"]),
            injector=FaultInjector(seed=run.seed + 1,
                                   crash_prob=mix["crash_prob"],
                                   straggler_prob=mix["straggler_prob"]))
        orch.run(job, chunks, self.make_worker, data={"tokens": tokens})
        try:
            preds = merge(self.store, job, chunks)
        except (AssertionError, KeyError):   # a chunk never committed
            preds = None
        return Job(k, 0, 0, items=n, tokens=0,
                   missing=0 if preds is not None else n, out=preds)

    def invoke_ms(self, jobs) -> list:
        keep = {j.index for j in jobs}
        out = []
        for rec in self.timings:
            if rec[0] not in keep:
                continue
            out.append(rec[1] if len(rec) == 2
                       else rec[1].elapsed_time(rec[2]))
        return out

    def release(self) -> None:
        """Drop the program's state: functions, store, engine."""
        self.workers.clear()
        self.store = self.engine = self.make_worker = None

    def compare(self, precision: str = "fp32", sample=None) -> dict:
        """Readings of the comparison over a sample of the window's items
        (drawn from the seed):

        - ``logit_err``: the largest gap between a logit
          ``Engine.classify_logits`` returned and the reference's, over
          the logits' natural scale (the RMS a logit has when the [CLS]
          state points anywhere: RMS of the state's norm times RMS of the
          head's column norms over sqrt(dim)), which unlike the logits'
          own RMS does not swing with where the state happens to point;
        - ``label_err``: items whose merged label is not the one their
          returned logits put first (exact: limit 0).

        With ``precision="fp8"`` the reference itself, computed in fp8,
        stands in the program's place."""
        run, mix = self.run, self.run.traffic
        items = []       # (tokens, merged label, returned logits or None)
        chunk = mix["chunk_items"]
        for j in run.counted:
            if j.out is None:
                continue
            rows = self.corpus.job(j.index)
            for i in range(len(rows)):
                got = self.logits.get((j.index, i - i % chunk))
                items.append((rows[i], int(j.out[i]),
                              None if got is None else got[i % chunk]))
        if not items:
            return {"logit_err": None, "label_err": None}
        if sample is None:
            rng = np.random.default_rng([run.seed, 0x5eed])
            sample = rng.choice(len(items),
                                size=min(mix["check_items"], len(items)),
                                replace=False)
        toks = torch.as_tensor(np.stack([items[i][0] for i in sample]),
                               device=run.device)
        spec = {"layer_norm_eps": self.mcfg.norm_eps,
                "n_heads": self.mcfg.n_heads}
        ref, state = encoder_logits(run.weights, toks, spec, Precision(),
                                    state=True)
        head = run.weights["cls_head"].float()
        scale = float(state.norm(dim=-1).pow(2).mean().sqrt()
                      * head.norm(dim=0).pow(2).mean().sqrt()
                      / state.shape[-1] ** 0.5)
        if precision == "fp32":
            got = [items[i][2] for i in sample]
            if any(g is None for g in got):
                return {"logit_err": None, "label_err": None}
            got = torch.as_tensor(np.stack(got), device=run.device).float()
            served = torch.tensor([items[i][1] for i in sample],
                                  device=run.device)
        else:
            got = encoder_logits(run.weights, toks, spec,
                                 Precision(precision))
            served = got.argmax(-1)
        return {"logit_err": float((got - ref).abs().max()) / scale,
                "label_err": float((served != got.argmax(-1)).sum())}
