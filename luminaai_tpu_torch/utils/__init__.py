"""Utilities of the port (the durable-I/O retry policy)."""
