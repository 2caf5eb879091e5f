"""HTTP serving over continuous batching."""
