"""Optimiser-side features of the port."""
