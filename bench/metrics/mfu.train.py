"""The whole training step's share of the card's peak: the model FLOPs of
the steps the traced window ran (6 x the parameters in products a token,
plus 12·D a kept pair a head a layer; recomputation not counted), over the
window's length times 989 TFLOP/s."""
from yardstick import peaks


def read(rec):
    t, w = rec.trace, rec.work
    if t is None or t.window_s <= 0 or not w.get("steps"):
        return None
    return 100.0 * w["steps"] * w["step_flops"] / (
        t.window_s * peaks.PEAK_BF16_FLOPS)
