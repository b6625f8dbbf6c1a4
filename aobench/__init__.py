"""The benchmark of the PyTorch / CUDA port, ``tpuao_torch``.

``python3 aobench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Cells,
configurations and metrics are files found by the names in the root
``BENCHMARK.json``: ``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<kind>.py``, ``metrics/<metric>.py``.
"""
