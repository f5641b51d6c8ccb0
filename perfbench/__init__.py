"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on; ``perfbench/run.py``'s docstring says what a run does.
"""
