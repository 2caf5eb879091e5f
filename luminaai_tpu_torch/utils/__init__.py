"""Utilities of the port: the durable-I/O retry policy (retry.py), the
host and card environment and diagnostics (environment.py), profiling
windows and timers (profiling.py) and the HTML reports (reporting.py)."""
