"""skybench: the benchmark of the PyTorch and CUDA port ``repro_torch``.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix): ``python3 skybench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the one
generator in ``cells.py``) and ``metrics/<metric>.py``. The yardstick
lives here too: the plain reference (``reference/``), the comparison that
decides ``correct`` (``judge.py``), the profiler reduction
(``devtrace.py``) and the peaks and operation counts (``roofline.py``).
"""
