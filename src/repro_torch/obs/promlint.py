"""Prometheus text-exposition lint: parse what ``render()`` emits.

Counterpart of ``repro.obs.promlint``: an independent re-parse of the
text format (v0.0.4) so ``GET /metrics`` is verified machine-readable by
something that is NOT the renderer. Checks:

  * line grammar — ``# HELP``/``# TYPE`` comments, then
    ``name{labels} value`` samples; anything else is an error;
  * metric names match ``[a-zA-Z_:][a-zA-Z0-9_:]*``, label names
    ``[a-zA-Z_][a-zA-Z0-9_]*``, label values are quoted with ``\\``,
    ``\"``, ``\n`` escapes, values parse as floats (``+Inf``/``-Inf``/
    ``NaN`` allowed);
  * every sample is preceded by a TYPE for its family
    (``_bucket``/``_sum``/``_count`` fold into their histogram), TYPE
    is one of counter|gauge|histogram|summary|untyped, and no family
    is TYPEd twice;
  * histogram series are well-formed per label-set: ``le`` bucket
    counts are monotone non-decreasing in ascending bound order, a
    ``+Inf`` bucket exists, and ``_count`` equals the ``+Inf`` count
    with a ``_sum`` present.

``lint_prometheus`` returns a list of error strings — empty means the
exposition passes.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)(?:\s+(?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*'
    r'"(?P<value>(?:[^"\\]|\\.)*)"\s*(?:,|$)')

_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _family(name: str, types: Dict[str, str]) -> str:
    """Fold histogram/summary component samples into their family."""
    for suf in _HIST_SUFFIXES:
        if name.endswith(suf):
            base = name[: -len(suf)]
            if types.get(base) in ("histogram", "summary"):
                return base
    return name


def _parse_value(s: str) -> float:
    if s in ("+Inf", "Inf"):
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    return float(s)          # NaN parses; anything else raises


def lint_prometheus(text: str) -> List[str]:
    """Parse ``text``; returns all format errors found (empty = pass)."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    # histogram family -> label-key (sans le) -> {"le": {bound: count},
    #                                             "sum": x, "count": n}
    hists: Dict[str, Dict[tuple, dict]] = {}

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                kind, name = parts[1], parts[2]
                if not _NAME_RE.match(name):
                    errors.append(f"line {lineno}: bad metric name "
                                  f"{name!r} in {kind}")
                    continue
                if kind == "TYPE":
                    t = parts[3].strip() if len(parts) > 3 else ""
                    if t not in _TYPES:
                        errors.append(f"line {lineno}: unknown TYPE "
                                      f"{t!r} for {name}")
                    if name in types:
                        errors.append(f"line {lineno}: duplicate TYPE "
                                      f"for {name}")
                    types[name] = t
                else:
                    if name in helps:
                        errors.append(f"line {lineno}: duplicate HELP "
                                      f"for {name}")
                    helps[name] = parts[3] if len(parts) > 3 else ""
            # other comments are legal and ignored
            continue

        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name = m.group("name")
        labels: List[Tuple[str, str]] = []
        raw_labels = m.group("labels")
        if raw_labels is not None:
            pos = 0
            while pos < len(raw_labels):
                lm = _LABEL_RE.match(raw_labels, pos)
                if not lm:
                    errors.append(f"line {lineno}: bad label syntax at "
                                  f"{raw_labels[pos:]!r}")
                    break
                labels.append((lm.group("name"), lm.group("value")))
                pos = lm.end()
        for ln, _ in labels:
            if not _LABEL_NAME_RE.match(ln):
                errors.append(f"line {lineno}: bad label name {ln!r}")
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            errors.append(f"line {lineno}: bad sample value "
                          f"{m.group('value')!r}")
            continue

        fam = _family(name, types)
        if fam not in types:
            errors.append(f"line {lineno}: sample {name} has no "
                          f"preceding TYPE")
            continue
        if types.get(fam) == "histogram":
            series = hists.setdefault(fam, {})
            key = tuple(sorted((ln, lv) for ln, lv in labels
                               if ln != "le"))
            child = series.setdefault(key, {"le": {}, "sum": None,
                                            "count": None})
            if name.endswith("_bucket"):
                le = dict(labels).get("le")
                if le is None:
                    errors.append(f"line {lineno}: histogram bucket "
                                  f"without le label")
                else:
                    child["le"][_parse_value(le)] = value
            elif name.endswith("_sum"):
                child["sum"] = value
            elif name.endswith("_count"):
                child["count"] = value
        elif types.get(fam) == "counter" and value < 0:
            errors.append(f"line {lineno}: counter {name} is negative")

    for fam, series in hists.items():
        for key, child in series.items():
            bounds = sorted(child["le"])
            if not bounds:
                errors.append(f"{fam}{dict(key)}: no buckets")
                continue
            if bounds[-1] != float("inf"):
                errors.append(f"{fam}{dict(key)}: missing +Inf bucket")
            counts = [child["le"][b] for b in bounds]
            if any(c1 < c0 for c0, c1 in zip(counts, counts[1:])):
                errors.append(f"{fam}{dict(key)}: bucket counts not "
                              f"monotone cumulative")
            if child["count"] is None or child["sum"] is None:
                errors.append(f"{fam}{dict(key)}: missing _sum/_count")
            elif (bounds[-1] == float("inf")
                  and child["count"] != child["le"][float('inf')]):
                errors.append(f"{fam}{dict(key)}: _count != +Inf bucket")
    return errors
