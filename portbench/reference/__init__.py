"""The plain reference the benchmark holds the port to: straightforward
PyTorch and NumPy of the same semantics.  It imports neither ``jax`` nor
either sitator package, and takes nothing the port made: it works from the
frames and centres the benchmark made itself."""
