"""The benchmark of csof_tpu_torch on NVIDIA H100s: ``python3 -m portbench.run``
(see ``run.py``), driven by ``BENCHMARK.json`` at the root of the repository."""
