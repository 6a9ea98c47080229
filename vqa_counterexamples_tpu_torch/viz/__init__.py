"""Training curves and qualitative grids (port of ``viz/``)."""
