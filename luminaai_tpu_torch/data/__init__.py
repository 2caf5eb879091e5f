"""Data-side pieces of the port (the byte tokenizer)."""
