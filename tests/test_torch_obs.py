"""The port's observability layer against the reference, byte for byte.

``repro_torch.obs`` keeps the reference's instruments, names, help text
and exposition format, so the same operations render the same Prometheus
text; its ``lint_prometheus`` gives the reference's verdicts; its
``TraceRecorder`` serialises the same JSONL; and the port's
``tools.trace_report`` prints the reference tool's report. The live
traces of both packages' routers are compared in
``test_torch_event_router.py``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs
from repro_torch.tools import trace_report

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive_registry(pkg):
    """The same instrument operations on a fresh registry of ``pkg``."""
    reg = pkg.MetricsRegistry()
    c = reg.counter("req_total", "requests", labelnames=("path", "code"))
    c.inc(3, path='/v1/"gen"\n', code=200)      # escaping stress
    c.inc(path="/metrics", code=404)
    c.inc(0.25, path="/metrics", code=404)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.inc(2.5)
    g.dec()
    h = reg.histogram("lat_seconds", "latency", labelnames=("op",))
    for v in (0.0, 1e-5, 0.001, 0.02, 0.3, 4.0, 1e4):
        h.observe(v, op="decode")
    h.observe(0.5, op="prefill")
    h2 = reg.histogram("h_seconds", "custom", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 500.0):
        h2.observe(v)
    return reg, h, h2


def _drive_observability(pkg):
    o = pkg.Observability(tracer=pkg.TraceRecorder())
    o.m_requests.inc(outcome="completed")
    o.m_requests.inc(2, outcome="rejected")
    o.m_admitted.inc(3)
    o.m_tokens.inc(48)
    o.m_ttft.observe(0.125)
    o.m_tpot.observe(0.02)
    o.m_round.observe(0.031)
    o.m_bucket_s.inc(0.01, bucket="prefill")
    o.m_replicas.set(2, state="ready")
    o.m_queue_depth.set(5)
    o.m_http_inflight.inc()
    o.m_pages.set(12, state="free")
    o.trace("queued", 0.0, rid=0)
    o.trace("admitted", 0.3, rid=0, replica=0)
    o.trace("round", 0.3, replica=0, round_s=0.2, n_active=1,
            crashed=False, rids=[0],
            buckets={"prefill": 0.05, "decode_attention": 0.08,
                     "sampler": 0.01, "host_scheduler": 0.02})
    o.trace("first_token", 0.35, rid=0)
    o.trace("decode_round", 0.5, rid=0, replica=0)
    o.trace("finish", 0.5, rid=0, n_tokens=2)
    o.trace("queued", 0.1, rid=1)
    o.trace("reject", 0.1, rid=1)
    o.trace("replica_start", 0.0, replica=0, ready_t=0.3)
    return o


def test_registry_renders_byte_equal_prometheus_text():
    reg, h, h2 = _drive_registry(obs)
    jreg, jh, jh2 = _drive_registry(jobs)
    text = reg.render()
    assert text == jreg.render()
    assert reg.snapshot() == jreg.snapshot()
    assert obs.lint_prometheus(text) == []
    for q in (0.0, 0.5, 0.9, 1.0):
        assert h.quantile(q, op="decode") == jh.quantile(q, op="decode")
        assert h2.quantile(q) == jh2.quantile(q)
    assert h2.cumulative() == jh2.cumulative()


def test_observability_catalog_and_buckets_equal_reference():
    assert obs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    assert obs.log_buckets(1e-2, 10.0, per_decade=2) == \
        jobs.log_buckets(1e-2, 10.0, per_decade=2)
    assert obs.OUTCOMES == jobs.OUTCOMES
    assert obs.SPAN_EVENTS == jobs.SPAN_EVENTS
    assert obs.TERMINAL_EVENTS == jobs.TERMINAL_EVENTS
    assert obs.Observability().registry.render() == \
        jobs.Observability().registry.render()
    o, jo = _drive_observability(obs), _drive_observability(jobs)
    assert o.registry.render() == jo.registry.render()
    assert o.tracer.dumps() == jo.tracer.dumps()


def test_loud_errors_match_reference():
    for pkg in (obs, jobs):
        reg = pkg.MetricsRegistry()
        c = reg.counter("c_total", "help", labelnames=("k",))
        with pytest.raises(ValueError, match="only go up"):
            c.inc(-1, k="a")
        with pytest.raises(ValueError, match="labels"):
            c.inc(wrong="a")
        with pytest.raises(ValueError, match="re-registered"):
            reg.gauge("c_total", "help")
        with pytest.raises(ValueError, match="increasing"):
            reg.histogram("h3", "x", buckets=(1.0, 1.0, 2.0))
        with pytest.raises(ValueError):
            pkg.log_buckets(0.0, 1.0)
        assert np.isnan(reg.histogram("h2_seconds", "x").quantile(0.5))


# the reference test suite's lint fixtures, good and malformed
LINT_CASES = {
    "no_type": "foo 1\n",
    "negative_counter": "# HELP c_total x\n# TYPE c_total counter\n"
                        "c_total -1\n",
    "non_monotone": "# HELP h x\n# TYPE h histogram\n"
                    'h_bucket{le="0.1"} 5\nh_bucket{le="1"} 3\n'
                    'h_bucket{le="+Inf"} 5\nh_sum 1\nh_count 5\n',
    "no_inf": "# HELP h x\n# TYPE h histogram\n"
              'h_bucket{le="0.1"} 5\nh_sum 1\nh_count 5\n',
    "count_mismatch": "# HELP h x\n# TYPE h histogram\n"
                      'h_bucket{le="+Inf"} 5\nh_sum 1\nh_count 4\n',
    "bad_label": "# HELP a x\n# TYPE a gauge\na{=} 1\n",
    "typed_twice": "# TYPE a gauge\n# TYPE a gauge\na 1\n",
    "bad_type": "# TYPE a widget\na 1\n",
    "bad_value": "# TYPE a gauge\na one\n",
    "special_values": "# TYPE a gauge\na +Inf\n# TYPE b gauge\nb NaN\n",
    "good": "# HELP g x\n# TYPE g gauge\ng{k=\"v\\\"q\"} 1.5\n",
}


@pytest.mark.parametrize("name", sorted(LINT_CASES))
def test_promlint_verdicts_equal_reference(name):
    text = LINT_CASES[name]
    assert obs.lint_prometheus(text) == jobs.lint_prometheus(text)


def test_promlint_verdicts_on_live_renders_equal_reference():
    text = _drive_registry(obs)[0].render()
    assert obs.lint_prometheus(text) == jobs.lint_prometheus(text) == []
    broken = text.replace("lat_seconds_count", "lat_seconds_total", 1)
    assert obs.lint_prometheus(broken) == jobs.lint_prometheus(broken)
    assert obs.lint_prometheus(broken)


def test_trace_jsonl_and_report_equal_reference(tmp_path, capsys):
    o, jo = _drive_observability(obs), _drive_observability(jobs)
    path, jpath = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    assert o.tracer.dump(str(path)) == jo.tracer.dump(str(jpath))
    assert path.read_bytes() == jpath.read_bytes()
    events = obs.load_jsonl(str(path))
    assert events == jobs.load_jsonl(str(jpath)) == o.tracer.events
    assert obs.spans_of(events) == jobs.spans_of(events) == o.tracer.spans()
    tool = _reference_tool("trace_report")
    for kw in ({}, {"width": 20, "limit": 1}):
        assert trace_report.report(trace_report.load(str(path)), **kw) == \
            tool.report(tool.load(str(jpath)), **kw)
    assert trace_report.main([str(path), "--limit", "1"]) == 0
    port_out = capsys.readouterr().out
    assert tool.main([str(jpath), "--limit", "1"]) == 0
    assert capsys.readouterr().out == port_out
