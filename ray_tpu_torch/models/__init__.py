"""Models of the port: plain dictionaries of tensors in the JAX pytrees'
structure, with the JAX module names (`llama`)."""
