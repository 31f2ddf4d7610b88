"""Serving layers: simulation-as-a-service over the vector-engine timing
model (``sim_service``)."""
