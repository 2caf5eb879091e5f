"""Monitoring of the port: metrics registry, flight recorder, goodput
ledger, hang watchdog, training health."""
