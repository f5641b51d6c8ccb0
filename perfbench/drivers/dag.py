"""LLM batch jobs through the batch DAG: shard -> prefill -> decode ->
reduce (``launch.serve.run_dag`` over ``dag_groups``' on-demand replica
pools, ``batch.BatchDagRunner.run``), on the engine ``launch.serve.
lm_engine`` builds around the benchmark's weights.

Set-up runs one small job (``warmup_items`` prompts of the cell's length,
``warmup_new_tokens`` new tokens) on the cell's replica shape, which
builds the kernels and warms every shape the window uses: a prompt's
prefill, an admission into the shared cache and a decode round over all
of a replica's slots. The comparison takes a sample of the window's
requests, drawn from the seed, and scores every token the reduce
committed for them under ``reference/decoder.py``'s full forward over
the prompt and the served tokens (greedy decoding: a served token's
logit may lie below the reference's best only by rounding).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import flops
from perfbench.harness import Job, Run, port_config
from perfbench.reference.decoder import decoder_logits
from perfbench.reference.lowp import Precision
from perfbench.traffic import Corpus
from perfbench.weights import make_weights


class Driver:
    def __init__(self, run: Run):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.launch.serve import lm_engine
        from repro_torch.models import build
        from repro_torch.router import ReplicaConfig

        self.run = run
        mix = run.traffic
        self.mcfg = port_config(run.config)
        run.weights = make_weights(build(self.mcfg).param_specs,
                                   run.config["init"], run.seed, run.device)
        self.engine, self.params = lm_engine(
            self.mcfg, device=run.device, params=run.weights,
            cache_pad=mix["cache_pad"])
        self.rcfg = ReplicaConfig(
            n_slots=mix["slots"],
            max_len=mix["prompt_len"] + mix["max_new_tokens"])
        self.corpus = Corpus(mix, self.mcfg.vocab_size, run.seed)
        p = run.probes
        p.wrap(self.engine, "prefill", "prefill",
               rows=lambda a, kw: len(a[1]))
        p.wrap(self.engine, "prefill_into", "admission",
               rows=lambda a, kw: len(a[3]))
        p.wrap(self.engine, "decode", "decode")
        p.record(fa_ops, "flash_attention", "flash", flops.flash_call)
        warm = self.corpus.job(0)[:mix["warmup_items"]]
        self._run(warm, mix["warmup_new_tokens"])

    def _run(self, tokens, n_new: int):
        from repro_torch.batch import BatchDataset
        from repro_torch.launch.serve import dag_groups, run_dag
        mix = self.run.traffic
        groups = dag_groups(self.engine, self.params, self.rcfg,
                            mix["workers"], spot_workers=mix["spot_workers"],
                            seed=self.run.seed)
        return run_dag(BatchDataset(tokens=tokens, max_new_tokens=n_new),
                       mix["shard_items"], groups,
                       per_token_s=mix["per_token_s"])

    def job(self, k: int) -> Job:
        n_new = self.run.traffic["max_new_tokens"]
        tokens = self.corpus.job(k)
        outputs = self._run(tokens, n_new).outputs
        done = {rid: toks for rid, toks in outputs.items()
                if len(toks) == n_new}
        return Job(k, 0, 0, items=len(tokens),
                   tokens=sum(len(t) for t in done.values()),
                   missing=len(tokens) - len(done), out=done)

    def release(self) -> None:
        """Drop the program's state (the engine and its shape buckets);
        the replica pools and their caches went with each job."""
        self.engine = self.params = None

    def compare(self, precision: str = "fp32", sample=None) -> dict:
        """``token_gap``: over a sample of the window's requests, the
        widest gap by which a served token's reference logit lies below
        the reference's best at its position. With ``precision="fp8"``
        the reference computed in fp8 stands in the program's place: at
        each position, the gap of the token it puts first."""
        run, mix = self.run, self.run.traffic
        reqs = [(j, rid) for j in run.counted if j.out
                for rid in sorted(j.out)]
        if not reqs:
            return {"token_gap": None}
        if sample is None:
            rng = np.random.default_rng([run.seed, 0x5eed])
            sample = rng.choice(len(reqs), size=min(mix["check_requests"],
                                                    len(reqs)),
                                replace=False)
        s = mix["prompt_len"]
        seqs, served = [], []
        for i in sample:
            j, rid = reqs[i]
            toks = j.out[rid]
            seqs.append(np.concatenate([self.corpus.job(j.index)[rid],
                                        np.asarray(toks[:-1], np.int32)]))
            served.append(toks)
        seqs = torch.as_tensor(np.stack(seqs), device=run.device)
        head_at = [range(s - 1, seqs.shape[1])] * len(seqs)
        spec = {"rms_norm_eps": self.mcfg.norm_eps,
                "rope_theta": self.mcfg.rope_theta}
        ref = decoder_logits(run.weights, seqs, spec, head_at, Precision())
        if precision == "fp32":
            picks = [torch.as_tensor(t, device=run.device).long()
                     for t in served]
        else:
            low = decoder_logits(run.weights, seqs, spec, head_at,
                                 Precision(precision))
            picks = [x.argmax(-1) for x in low]
        gap = max(float((r.max(-1).values
                         - r.gather(1, p[:, None])[:, 0]).max())
                  for r, p in zip(ref, picks))
        return {"token_gap": gap}

