"""Example problems of the port (copies of the JAX package's
``examples/``, one per ported slice)."""
