"""Scripts that run the port's CLIs (port of the JAX package's ``scripts/``)."""
