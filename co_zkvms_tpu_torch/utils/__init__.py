"""Kernel build and JAX-package data conversion."""
