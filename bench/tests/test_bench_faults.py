"""A whole run on the host at tiny widths (the look for a card skipped),
sound and with the timed path broken underneath: ``correct`` is true for
the sound program and false for each fault the cell can have."""
import pytest

from bench_small import run_small, workloads

TRAIN = workloads("train")
SERVE = workloads("prefill_waves")


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell):
    rc, line, err = run_small(cell)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]
    for c in line["checks"]:
        assert f"check {c} =" in err


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_returns_its_state_unchanged_is_caught(cell, monkeypatch):
    from repro_torch.train import optimizer

    def unchanged(cfg, params, grads, state, gnorm=None):
        return params, state, {"grad_norm": optimizer.global_norm(grads),
                               "lr": optimizer.lr_at(cfg, state.step)}

    monkeypatch.setattr(optimizer, "apply_", unchanged)
    rc, line, err = run_small(cell)
    assert rc == 0 and line["correct"] is False, err
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_is_caught(cell, monkeypatch):
    from repro_torch.models import transformer
    loss_fn = transformer.loss_fn

    def half(params, batch, cfg):
        return loss_fn(params, {k: v[:v.shape[0] // 2] for k, v in batch.items()},
                       cfg)

    monkeypatch.setattr(transformer, "loss_fn", half)
    rc, line, err = run_small(cell)
    assert rc == 0 and line["correct"] is False, err


def _family_module(cell):
    from bench_small import small_cell
    from repro_torch.models import moe, transformer
    fam = small_cell(cell).config["program"]["family"]
    return moe if fam == "moe" else transformer


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    mod = _family_module(cell)
    prefill = mod.prefill

    def altered(params, tokens, cfg, max_seq):
        logits, cache = prefill(params, tokens, cfg, max_seq)
        logits = logits.clone()
        top = logits[0, -1].argmax()
        logits[0, -1, top] -= 5.0               # another token is served
        return logits, cache

    monkeypatch.setattr(mod, "prefill", altered)
    rc, line, err = run_small(cell)
    assert rc == 0 and line["correct"] is False, err


@pytest.mark.parametrize("cell", SERVE)
def test_half_of_a_wave_left_out_is_caught(cell, monkeypatch):
    from repro_torch.serve import engine
    submit = engine.ServeEngine.submit

    def every_other(self, req):
        if req.uid % 2 == 0:
            submit(self, req)

    monkeypatch.setattr(engine.ServeEngine, "submit", every_other)
    rc, line, err = run_small(cell)
    assert rc == 0 and line["correct"] is False, err
    assert line["failed"] > 0


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_traced_run_reports_per_layer_metrics(cell):
    rc, line, err = run_small(cell, trace=1)
    assert rc == 0 and line["correct"] is True, err
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # on the host the device metrics find nothing and are left out; the
    # harness's counters are read
    assert not any(k.startswith("flash_") for k in line["metrics"])
