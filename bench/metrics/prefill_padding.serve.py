"""The serve engine's padding: padded positions over all positions handed
to ``model.prefill`` in the traced window, counted by the harness's proxy
of the model (positions handed) and its own record of the prompts (real
positions)."""


def read(rec):
    n = rec.counters.get("prefill_positions", 0)
    if not n:
        return None
    return 100.0 * (n - rec.counters["prefill_real_positions"]) / n
