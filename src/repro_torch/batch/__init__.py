"""repro_torch.batch — the offline batch-inference DAG workload.

Counterpart of ``repro.batch``, with the same exports. The paper's case
study beside the online router: shard a dataset, prefill + decode each
shard on serverless-style replica workers spread over heterogeneous
spot/on-demand cloud pools, reduce the outputs — with checkpointed
exactly-once task effects so spot preemption moves the timeline, never
the answer.
"""
from repro_torch.batch.chaos import (Kill, chaos_ladder, kills_by_group,
                                     next_boundary_kill)
from repro_torch.batch.dag import (DECODE, DONE, PENDING, PREEMPTED,
                                   PREFILL, READY, REDUCE, RUNNING, SHARD,
                                   STATES, TaskDag, TaskSpec, inference_dag)
from repro_torch.batch.runner import (BatchDagRunner, BatchDataset,
                                      DagReport, PlacementPolicy,
                                      WorkerGroup, make_dataset, make_group)

__all__ = [
    "TaskDag", "TaskSpec", "inference_dag", "STATES",
    "PENDING", "READY", "RUNNING", "DONE", "PREEMPTED",
    "SHARD", "PREFILL", "DECODE", "REDUCE",
    "BatchDagRunner", "BatchDataset", "DagReport", "PlacementPolicy",
    "WorkerGroup", "make_dataset", "make_group",
    "Kill", "chaos_ladder", "kills_by_group", "next_boundary_kill",
]
