"""The train and eval steps, on one card and over a mesh (the JAX
package's parallel/: mesh, sharding, grad_reduce, expert_dispatch,
pipeline, train_step)."""
