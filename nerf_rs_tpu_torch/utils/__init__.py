"""Utilities of the PyTorch port: phase timers, progress and device traces
(``profiling``)."""
