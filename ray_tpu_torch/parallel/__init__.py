"""Parallel layers of the port: the one-device Mixture-of-Experts layer
(`moe`)."""
