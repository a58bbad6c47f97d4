"""The port's segment reader (a copy of the JAX package's) and its residency on a torch device."""
