"""Measurement helpers of the port (``profiling.py``)."""
