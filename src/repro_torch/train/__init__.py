"""Training pieces: AdamW with warmup and a cosine schedule (``optimizer``)."""
