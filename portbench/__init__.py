"""The port's benchmark: fits of the paper's algorithm scripts through
``repro_torch`` on one card, driven by the data in ``BENCHMARK.json`` and
the files under this folder (see ``run.py``)."""
