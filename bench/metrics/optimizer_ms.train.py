"""The trainer's optimizer: milliseconds a step inside
``repro_torch.train.optimizer.apply_``, from CUDA events around each call
(the train step calls it as ``opt.apply_``, so the wrapper set on the
module sees every call); the window's sum over its steps."""


def install(spans):
    from repro_torch.train import optimizer
    spans.wrap(optimizer, "apply_", "optimizer")


def read(rec):
    s = rec.spans.seconds("optimizer")
    steps = rec.work.get("steps", 0)
    if not s or not steps:
        return None
    return 1e3 * sum(s) / steps
