"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
``reference/`` is the yardstick: the frozen trace generator, policies,
scalar event loop, roofline arithmetic and the comparison that decides
``correct``; it imports nothing of the program.
"""
