"""Accelerator tables of the port (NVIDIA cards)."""
