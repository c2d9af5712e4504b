"""Measurement helpers of the port (``profiling.py``) and its spans and
counters (``trace.py``)."""
