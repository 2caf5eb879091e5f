"""Data-side pieces of the port: tokenizers, datasets and packing,
processing and blending, and the OASST acquisition (acquisition.py)."""
