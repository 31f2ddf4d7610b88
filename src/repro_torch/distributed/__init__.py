"""Distributed pieces of the trainer: int8 gradient compression
(``compression``).  Sharding, collectives and the pipeline schedule of the
reference's ``distributed/`` are not ported yet."""
