"""The harness on the CPU: ``BENCHMARK.json`` against the benchmark's
contract, every cell's files found by name, the metric arithmetic on
canned records, the FLOP and byte counts at the configurations' shapes,
and the modules a run loads."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import types

import numpy as np
import pytest

from perfbench import flops, harness
from perfbench.harness import BENCH, ROOT, load_json, load_module
from perfbench.trace import _label_gaps

SPEC = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a check of 24 cells (2 + 14 x 24 runs of run_seconds + 60 s each,
    # 180 s of compiles a cell, 1 200 s spare) fits in 43 200 s
    assert 1200 + (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    assert len(set(CELLS)) == len(CELLS)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        c = harness.load_cell(cell)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e   # the metric it moves is reported


def test_every_cell_finds_its_files_by_name():
    for cell in CELLS:
        c = harness.load_cell(cell)
        assert (BENCH / "drivers" / f"{c.traffic['path']}.py").exists()
        for m in c.end_to_end + c.per_layer:
            assert hasattr(load_module(harness.reader_path(m["name"])),
                           "read")
        assert c.limits["missing"]["limit"] == 0
        for name, entry in c.limits.items():
            assert entry["limit"] is not None, (cell, name)
        cfg = harness.port_config(c.config)
        assert cfg.d_model in (768, 3584)


def test_a_split_name_reads_with_its_base_reader_unless_it_has_its_own():
    assert harness.reader_path("mfu_pct.dag") == BENCH / "metrics" / \
        "mfu_pct.py"
    assert harness.reader_path("mfu_pct") == BENCH / "metrics" / "mfu_pct.py"
    assert harness.reader_path("device_idle_pct.dag.x").name == \
        "device_idle_pct.py"
    own = sorted(p.stem for p in (BENCH / "metrics").glob("*.py"))
    assert all(harness.reader_path(n).stem == n for n in own)


def test_configuration_files_keep_the_published_widths():
    bert = harness.port_config(load_json(BENCH / "configs"
                                         / "distilbert-imdb.json"))
    assert (bert.n_layers, bert.d_model, bert.n_heads, bert.head_dim,
            bert.d_ff, bert.vocab_size, bert.max_position,
            bert.num_labels) == (6, 768, 12, 64, 3072, 30522, 512, 2)
    qwen = harness.port_config(load_json(BENCH / "configs" / "qwen2-7b.json"))
    assert (qwen.n_layers, qwen.d_model, qwen.n_heads, qwen.n_kv_heads,
            qwen.head_dim, qwen.d_ff, qwen.vocab_size, qwen.rope_theta,
            qwen.norm_eps) == (28, 3584, 28, 4, 128, 18944, 152064, 1e6,
                               1e-6)


def _cfg(name):
    return harness.port_config(load_json(BENCH / "configs"
                                         / f"{name}.json"))


def test_flop_and_byte_counts_at_the_configurations_shapes():
    bert, qwen = _cfg("distilbert-imdb"), _cfg("qwen2-7b")
    # distilbert: 6 x (q, k, v, o: 4 x 768^2; mlp: 2 x 768 x 3072)
    assert flops.matmul_params(bert) == 6 * (4 * 768 ** 2 + 2 * 768 * 3072)
    assert flops.classify_flops(bert, 512) == (
        2 * 42_467_328 * 512 + 4 * 6 * 768 * 512 ** 2 + 2 * 768 * 2)
    # qwen2-7b: 28 x (q, o: 3584^2; k, v: 3584 x 512; mlp: 3 x 3584 x 18944)
    assert flops.matmul_params(qwen) == 28 * 233_046_016 == 6_525_288_448
    head = 2 * 3584 * 152064
    prefill = 2 * 6_525_288_448 * 1024 + 4 * 28 * 3584 * 1024 * 1025 / 2 \
        + head
    # 7 decode steps attending 1025 .. 1031 positions
    decode = 7 * (2 * 6_525_288_448 + head) + 4 * 28 * 3584 * sum(
        range(1025, 1032))
    assert flops.generate_flops(qwen, 1024, 8) == pytest.approx(
        prefill + decode, rel=1e-12)
    # the kernels' calls
    assert flops.flash_bytes(32, 512, 512, 12, 12, 64) == 100_663_296
    assert flops.flash_flops(32, 512, 512, 12, 64, False) == \
        4 * 32 * 12 * 64 * 512 * 512
    assert flops.flash_flops(1, 1024, 1024, 28, 128, True) == \
        4 * 28 * 128 * 1024 * 1025 / 2
    assert flops.least_s(1e12, 1) == pytest.approx(1e12 / 989e12)
    assert flops.least_s(1, 3.35e9) == pytest.approx(1e-3)


def _run(cell="qwen2-7b.dag-label-4k"):
    """A finished window with canned jobs, spans, calls and trace."""
    run = harness.Run(harness.load_cell(cell), seed=1, seconds=10.0,
                      trace=True, device="cpu")
    run.window_t0 = 0
    jobs = [harness.Job(0, 0, 4_000_000_000, items=64, tokens=512,
                        missing=0),
            harness.Job(1, 4_000_000_000, 9_000_000_000, items=64,
                        tokens=512, missing=4),
            harness.Job(2, 9_000_000_000, 14_000_000_000, items=64,
                        tokens=512, missing=0)]
    run.jobs, run.counted = jobs, jobs[:2]
    run.driver = types.SimpleNamespace(mcfg=_cfg("qwen2-7b"))
    return run


def test_rates_take_the_whole_window_to_the_last_counted_job():
    run = _run()
    for name in ("items_per_s", "items_per_s.dag"):
        items = load_module(harness.reader_path(name)).read(run)
        assert items == pytest.approx((64 + 60) / 9.0)
    mfu = load_module(BENCH / "metrics" / "mfu_pct.py").read(run)
    assert mfu == pytest.approx(100 * 124 * flops.generate_flops(
        _cfg("qwen2-7b"), 4096, 16) / 9.0 / 989e12)


def test_the_tail_is_over_every_invocation():
    run = _run()
    ms = list(range(1, 201))        # 200 invocations of 1 .. 200 ms
    run.driver.invoke_ms = lambda jobs: ms
    p95 = load_module(BENCH / "metrics" / "invoke_p95_ms.py").read(run)
    assert p95 == pytest.approx(np.percentile(ms, 95)) == 190.05


def test_layer_readers_on_canned_spans_and_calls():
    run = _run()
    p = run.probes
    p.counts = {("prefill_rows", 0): 64, ("admission_rows", 0): 64,
                ("prefill_rows", 1): 64, ("admission_rows", 1): 64,
                ("prefill_rows", 2): 64}
    pp = load_module(BENCH / "metrics" / "prefill_passes_per_item.py")
    assert pp.read(run) == pytest.approx(256 / 124)
    p.calls["flash"] = [(0, 1, 1024, 1024, 28, 4, 128, True)] * 10 + \
        [(2, 1, 1024, 1024, 28, 4, 128, True)]
    run.summary = {"by_name": {"void flash_fwd_wgmma_kernel<128, 1>": 0.2,
                               "gemm": 1.0},
                   "busy_s": 2.5, "window_s": 10.0}
    least = 10 * flops.least_s(flops.flash_flops(1, 1024, 1024, 28, 128,
                                                 True),
                               flops.flash_bytes(1, 1024, 1024, 28, 4, 128))
    for name in ("flash_roofline", "flash_roofline.dag"):
        fr = load_module(harness.reader_path(name)).read(run)
        assert fr == pytest.approx(100 * least / 0.2)
    idle = load_module(BENCH / "metrics" / "device_idle_pct.py").read(run)
    assert idle == pytest.approx(75.0)
    run.summary = {}
    assert load_module(BENCH / "metrics" / "flash_roofline.py").read(run) \
        is None


def test_idle_gaps_take_the_innermost_host_span():
    spans = [("job", 0, 1000, 0), ("decode", 100, 200, 0),
             ("decode", 300, 400, 0), ("admission", 500, 600, 0)]
    gaps = [(110, 130), (250, 260), (550, 570), (1100, 1200)]
    out = _label_gaps(gaps, spans, offset=0)
    assert out == pytest.approx({"decode": 20e-9, "job": 10e-9,
                                 "admission": 20e-9, "harness": 100e-9})
    shifted = _label_gaps([(1110, 1130)], spans, offset=1000)
    assert shifted == pytest.approx({"decode": 20e-9})


def test_judge_needs_a_reading_and_a_limit():
    limits = {"a": {"limit": 1.0}, "b": {"limit": 0}}
    assert harness.judge({"a": 0.5, "b": 0.0}, limits)[0]
    assert not harness.judge({"a": 1.5, "b": 0.0}, limits)[0]
    assert not harness.judge({"a": None, "b": 0.0}, limits)[0]
    assert not harness.judge({"c": 0.0}, limits)[0]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    code = ("import perfbench.run, perfbench.control\n"
            "from perfbench.harness import BENCH, load_module\n"
            "for sub in ('drivers', 'metrics'):\n"
            "    for f in sorted((BENCH / sub).glob('*.py')):\n"
            "        load_module(f)\n"
            "import perfbench.drivers.dag, perfbench.drivers.orchestrator\n"
            "from repro_torch.launch import serve\n")
    names = _loaded(code)
    assert "repro_torch" in names and "perfbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded("import perfbench.reference.encoder, "
                    "perfbench.reference.decoder")
    assert not names & {"repro_torch", "jax", "jaxlib", "flax", "repro",
                        "benchmarks"}
