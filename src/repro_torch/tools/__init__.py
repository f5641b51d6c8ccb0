"""Command-line tools of the port (counterparts of the repository's
``tools/``), e.g. ``python -m repro_torch.tools.trace_report TRACE.jsonl``."""
