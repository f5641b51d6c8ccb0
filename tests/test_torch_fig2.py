"""The port's Fig. 2 (calibrated simulator and sweep) against the reference.

``repro_torch.core.simulator`` and ``repro_torch.benchmarks.fig2`` run the
paper-scale case study (25k items, the paper's Lambda constants) through
the port's orchestrator and monolithic runner. Every ``JobReport.summary()``
and every row and claim of the sweep must EQUAL the reference's: the
simulator is pure host arithmetic on the same constants. The two examples
(quickstart, the case study's serving and sweep parts) run on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import fig2 as jfig2
from repro.core import simulator as jsim
from repro_torch import configs
from repro_torch.benchmarks import fig2
from repro_torch.core import simulator
from repro_torch.data import imdb_reviews
from repro_torch.examples import quickstart, sentiment_case_study
from repro_torch.models import RunConfig, build
from repro_torch.serving import Engine

SWEEP = [50, 100, 500, 625, 1000]


@pytest.fixture(scope="module")
def sweeps():
    return (fig2.rows(simulator.CaseStudyConfig(), batch_sizes=SWEEP),
            jfig2.rows(jsim.CaseStudyConfig(), batch_sizes=SWEEP))


def test_constants_equal_the_reference():
    assert dataclasses.asdict(simulator.CaseStudyConfig()) == \
        dataclasses.asdict(jsim.CaseStudyConfig())
    assert simulator.PAPER_BATCH_SIZES == jsim.PAPER_BATCH_SIZES
    assert fig2.PAPER == jfig2.PAPER


@pytest.mark.parametrize("mode", ["monolithic", "parallel"])
@pytest.mark.parametrize("batch_size", SWEEP)
def test_job_report_equals_reference(mode, batch_size):
    run, jrun = (getattr(simulator, f"run_{mode}"),
                 getattr(jsim, f"run_{mode}"))
    got = run(simulator.CaseStudyConfig(), batch_size)
    want = jrun(jsim.CaseStudyConfig(), batch_size)
    assert got.summary() == want.summary()
    assert got.total_billed_s == want.total_billed_s


def test_rows_and_claims_equal_reference(sweeps):
    got, want = sweeps
    assert got == want
    checks = fig2.validate(got)
    assert checks == jfig2.validate(want)
    assert all(checks.values()), checks


def test_sweep_at_measured_compute_equals_reference():
    """The ungated row set (the card's per-item time in place of the
    paper's) goes through the same arithmetic as the reference's."""
    cs = dataclasses.replace(simulator.CaseStudyConfig(), per_item_s=3e-4)
    jcs = dataclasses.replace(jsim.CaseStudyConfig(), per_item_s=3e-4)
    got, want = fig2.rows(cs, SWEEP), jfig2.rows(jcs, SWEEP)
    assert got == want
    assert fig2.validate(got) == jfig2.validate(want)


def test_run_sweep_equals_reference():
    assert simulator.run_sweep(batch_sizes=[50, 1000]) == \
        jsim.run_sweep(batch_sizes=[50, 1000])


def test_bench_labels_the_measured_row_set(monkeypatch):
    monkeypatch.setattr(fig2, "measure_real_per_item",
                        lambda device="cuda": 3e-4)
    rows = fig2.bench(device="cpu")
    names = [r[0] for r in rows]
    assert names[0] == "fig2/real_distilbert_per_item"
    paper = {n: d for n, _, d in rows if n.startswith("fig2/check_")}
    measured = {n: d for n, _, d in rows
                if n.startswith("fig2_measured/check_")}
    assert set(paper.values()) == {"PASS"} and len(paper) == 6
    assert len(measured) == 6 and "FAIL" in measured.values()


def test_measure_real_per_item_runs_the_engine():
    cfg = configs.smoke("distilbert-imdb")
    per_item = fig2.measure_real_per_item(n_items=8, batch=4, seq_len=16,
                                          device="cpu", cfg=cfg)
    assert 0.0 < per_item < 1.0


def test_quickstart_runs_and_merges_every_item():
    out = quickstart.main(["--device", "cpu"])
    assert out["predictions"].shape == (128,)
    assert out["mono"]["batch_size"] == out["par"]["batch_size"] == 16
    assert out["par"]["n_invocations"] == 8     # one function a chunk
    assert 0.0 <= out["accuracy"] <= 1.0


def test_case_study_serves_exactly_and_sweeps():
    out = sentiment_case_study.main(["--device", "cpu"])
    # the example asserts merge == classify itself; check its result too
    cfg = configs.smoke("distilbert-imdb")
    model = build(cfg)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0), engine.device)
    tokens, _ = imdb_reviews(n=512, seq_len=48, vocab=cfg.vocab_size,
                             signal_frac=0.15)
    np.testing.assert_array_equal(out["predictions"],
                                  engine.classify(params, tokens[384:]))
    for bs, mono, par in out["sweep"]:
        assert mono == jsim.run_monolithic(jsim.CaseStudyConfig(),
                                           bs).summary()
        assert par == jsim.run_parallel(jsim.CaseStudyConfig(),
                                        bs).summary()
