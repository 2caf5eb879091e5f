"""Model layers and the transformer."""
