"""The mesh path: logical-axis sharding and its DTensor placements
(``sharding``), the named-axis collectives and the flash decode over a
sequence-sharded cache (``collectives``), the pipeline schedule
(``pipeline``), and the trainer's int8 gradient compression
(``compression``)."""
