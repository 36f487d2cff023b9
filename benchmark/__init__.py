"""The benchmark of ``crfr_torch`` on NVIDIA H100 cards: ``BENCHMARK.json``
at the checkout's root names the cells; ``run.py`` runs one."""
