"""Dispersion operators: flattening, secular functions, kernels, solver."""
