"""Benchmarks of the port (counterpart of the JAX package's
``benchmarks/``): the analytic FLOP and byte counts behind MFU and the
decode roofline (``roofline``), the device-memory peak (``mem_monitor``)
and the latency/throughput grid CLI (``benchmark``, with ``bench_zoo``
over the causal-LM zoo's named configurations, ``allowed_configs``), and
the data-parallel scaling ladder (``scaling``, under ``torchrun``). The
one-line JSON bench is ``cli/bench.py``.
"""
