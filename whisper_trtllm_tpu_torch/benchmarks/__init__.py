"""Benchmarks of the port (counterpart of the JAX package's
``benchmarks/``): the analytic FLOP and byte counts behind MFU and the
decode roofline (``roofline``), the device-memory peak (``mem_monitor``)
and the latency/throughput grid CLI (``benchmark``), and the
data-parallel scaling ladder (``scaling``, under ``torchrun``). The
one-line JSON bench is ``cli/bench.py``.

Not ported yet: ``allowed_configs.py`` and ``bench_zoo`` (the causal-LM
zoo).
"""
