"""Models with the JAX package's parameter layout (ResNet and LeNet so far;
the rest of the zoo is queued in ROADMAP)."""
