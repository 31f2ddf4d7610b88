"""The whole prefill's share of the card's peak: the model FLOPs of the
waves the traced window ran (2 x the active parameters in products a real
token, top-k experts and no capacity slack, 4·D a kept pair of real
positions a head a layer, the unembedding at one position a request;
padding not counted), over the window's length times 989 TFLOP/s."""
from yardstick import peaks


def read(rec):
    t, w = rec.trace, rec.work
    if t is None or t.window_s <= 0 or not w.get("model_flops"):
        return None
    return 100.0 * w["model_flops"] / (t.window_s * peaks.PEAK_BF16_FLOPS)
