"""wrfbench: the benchmark of the PyTorch and CUDA port (``wrf_tpu_torch``).

``python3 -m wrfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card (see
:mod:`wrfbench.run`).  The package holds the yardstick that the program
cannot change: the seeded inputs (:mod:`wrfbench.inputs`), the plain
reference (:mod:`wrfbench.reference`), the comparison that decides
``correct`` (:mod:`wrfbench.check`), the frozen traffic model and the
card's peaks (:mod:`wrfbench.traffic`, :mod:`wrfbench.yardstick`), the
trace reduction (:mod:`wrfbench.trace`) and one reader per metric
(``wrfbench/metrics/``).  Only :mod:`wrfbench.program` imports the
program.  Outside the benchmark's runs: :mod:`wrfbench.control` reads the
program, the control and the faults over many seeds (what the limits are
set from), and :mod:`wrfbench.stability` checks a configuration's
dynamics on the CPU.
"""
