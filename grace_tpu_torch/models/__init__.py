"""Models with the JAX package's parameter layout (ResNet so far; LeNet and
the rest of the zoo are queued in ROADMAP)."""
