"""The benchmark of ``repro_torch`` on the card (``BENCHMARK.json``)."""
