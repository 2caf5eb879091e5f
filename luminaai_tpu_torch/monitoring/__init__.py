"""Monitoring of the port: metrics registry, flight recorder, goodput
ledger, hang watchdog, training health, SLOs and the time-series ring,
span tracing, and performance attribution (attribution.py)."""
