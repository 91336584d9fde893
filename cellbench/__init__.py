"""The port's cell benchmark: one run of one cell per process (``run.py``)."""
