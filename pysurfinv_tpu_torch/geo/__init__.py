"""Geographic grids, 3-D model assembly, exchange and decorations."""
