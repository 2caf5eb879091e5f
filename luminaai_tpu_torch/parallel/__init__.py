"""The train and eval steps (the JAX package's parallel/train_step.py,
without a mesh: the port trains on one card)."""
