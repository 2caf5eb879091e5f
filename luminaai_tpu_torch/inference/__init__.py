"""KV pool, generation engine and step-wise decoder."""
