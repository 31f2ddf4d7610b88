"""Vector-engine configuration grids."""
