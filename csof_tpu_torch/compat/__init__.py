"""Parameter import from the JAX package's flax trees."""
