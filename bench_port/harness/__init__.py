"""The general harness: one cell, one run (``run.py``)."""
