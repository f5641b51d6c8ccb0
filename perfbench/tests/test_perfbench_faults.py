"""Whole runs of each cell on the CPU at a tiny size (the same harness and
program paths, with the look for a chip skipped): a sound run is correct
by the cell's own limits, and a run with the timed path broken underneath
is not, once for each fault a one-chip inference cell can have.

Faults are planted in the program (``Engine``) before the run builds it:
- an answer altered where it is produced (a label flipped in the
  classifier's logits or after them; a token forced in the decode step's
  logits);
- half of the batch left out (the second half of the rows given the
  first half's answers);
- a step that returns its state unchanged (a decode step that leaves the
  cache's lengths where they were).
The exchange between chips does not exist on one chip.
"""
from __future__ import annotations

import pytest
import torch

from perfbench.run import run_cell
from perfbench.tests.cells import tiny
from repro_torch.serving.engine import Engine

OFFLINE = "distilbert-imdb.offline-512"
DAGS = ["qwen2-7b.dag-label-4k"]


def _run(cell, seed=2 ** 31 + 11):
    return run_cell(cell, seed, 0.2, False, **tiny(cell))


@pytest.mark.parametrize("cell", [OFFLINE] + DAGS)
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0


def _flip_labels(orig):
    def f(self, params, tokens):
        out = orig(self, params, tokens).copy()
        out[::2] = out[::2, ::-1]          # every other answer flipped
        return out
    return f


def _half_batch(orig):
    def f(self, params, tokens):
        out = orig(self, params, tokens).copy()
        h = len(out) // 2
        out[h:2 * h] = out[:h]             # rows past half: first half's
        return out
    return f


@pytest.mark.parametrize("fault", [_flip_labels, _half_batch])
def test_a_broken_classifier_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(Engine, "classify_logits",
                        fault(Engine.classify_logits))
    assert not _run(OFFLINE)["correct"]


def test_a_label_altered_after_its_logits_is_not_correct(monkeypatch):
    orig = Engine.classify

    def flip(self, params, tokens):
        out = orig(self, params, tokens).copy()
        out[::2] = 1 - out[::2]            # every other answer flipped
        return out
    monkeypatch.setattr(Engine, "classify", flip)
    assert not _run(OFFLINE)["correct"]


def _forced_token(orig):
    def f(self, params, cache, token):
        logits, cache = orig(self, params, cache, token)
        logits = logits.clone()
        logits[:, 7] += 1e4                # every row's token becomes 7
        return logits, cache
    return f


def _half_rows(orig):
    def f(self, params, cache, token):
        logits, cache = orig(self, params, cache, token)
        logits = logits.clone()
        h = logits.shape[0] // 2
        logits[h:2 * h] = logits[:h]
        return logits, cache
    return f


def _state_unchanged(orig):
    def f(self, params, cache, token):
        logits, cache = orig(self, params, cache, token)
        cache.lengths.sub_(1)              # the step leaves no trace
        return logits, cache
    return f


@pytest.mark.parametrize("cell", DAGS)
@pytest.mark.parametrize("fault", [_forced_token, _half_rows,
                                   _state_unchanged])
def test_a_broken_decode_is_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(Engine, "decode", fault(Engine.decode))
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", DAGS)
def test_a_prompt_pass_that_forces_its_token_is_not_correct(monkeypatch,
                                                            cell):
    """The prefill stage's pass and the admission's both put token 7
    first, so the stage handoff holds and only the comparison sees it."""
    def forced(orig):
        def f(self, *args, **kwargs):
            logits, cache = orig(self, *args, **kwargs)
            logits = logits.clone()
            logits[..., 7] += 1e4
            return logits, cache
        return f
    monkeypatch.setattr(Engine, "prefill", forced(Engine.prefill))
    monkeypatch.setattr(Engine, "prefill_into", forced(Engine.prefill_into))
    assert not _run(cell)["correct"]


def test_an_answer_that_never_comes_is_not_correct(monkeypatch):
    from repro_torch.batch import runner
    orig = runner.BatchDagRunner.run

    def drop_one(self, *a, **kw):
        report = orig(self, *a, **kw)
        report.outputs.pop(min(report.outputs))
        return report
    monkeypatch.setattr(runner.BatchDagRunner, "run", drop_one)
    r = _run(DAGS[0])
    assert not r["correct"] and r["failed"] > 0


class _CannedTracer:
    """The profiler's stand-in on the CPU: a device trace of canned
    kernel times."""

    def __init__(self, on):
        self.on = on

    def start(self):
        pass

    def mark(self):
        pass

    def stop(self):
        pass

    def read(self, n_counted, spans):
        return {"busy_s": 1.0, "window_s": 4.0,
                "by_name": {"void flash_fwd_kernel": 1e-3,
                            "void decode_kernel<bf16>": 1e-3},
                "idle_by_span": {"decode": 2.0}}


@pytest.mark.parametrize("cell", [OFFLINE] + DAGS)
def test_a_traced_run_reads_host_metrics_outside_the_profiler(monkeypatch,
                                                              cell):
    """Host clocks and counters come from the untraced window, the device
    trace's metrics from a second window under the profiler, and the
    comparison covers both windows' jobs."""
    import perfbench.harness as harness
    import perfbench.run as run_mod
    seen, read = [], harness.read_metrics

    def spy(run, metrics):
        seen.append(([m["source"] for m in metrics],
                     [j.index for j in run.counted]))
        return read(run, metrics)
    monkeypatch.setattr(run_mod, "Tracer", _CannedTracer)
    monkeypatch.setattr(harness, "read_metrics", spy)
    r = run_cell(cell, 2 ** 31 + 17, 0.2, True, **tiny(cell))
    assert r["correct"], r["checks"]
    (host, first), (dev, second) = seen
    assert "device_trace" not in host and set(dev) == {"device_trace"}
    assert first[0] == 0 and second[0] > first[-1]
    per_layer = [m["name"] for m in harness.load_cell(cell).per_layer]
    assert list(r["metrics"]) == per_layer
    assert r["device"]["busy_s"] == 1.0 and r["breakdown"]["idle_gaps"]
    assert r["attempted"] >= 2 * tiny(cell)["traffic_over"]["items_per_job"]
