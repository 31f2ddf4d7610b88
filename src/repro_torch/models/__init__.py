"""Model building blocks of the port (so far the Mamba-2 SSD oracle)."""
