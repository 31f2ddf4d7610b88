"""The traffic generator and the weights repeat exactly for a seed."""
import json

import numpy as np
import pytest
import torch

from bench_small import ROOT, SEED
from yardstick import tokens, traffic, weights as W

PREFILL = json.loads((ROOT / "bench/traffic/prefill-4k.json").read_text())
TRAIN = json.loads((ROOT / "bench/traffic/train-4k.json").read_text())


def test_token_rows_repeat_for_a_seed_and_differ_for_another():
    a = tokens.rows(SEED, 3, 2, 64, 1000)
    assert np.array_equal(a, tokens.rows(SEED, 3, 2, 64, 1000))
    assert not np.array_equal(a, tokens.rows(SEED + 1, 3, 2, 64, 1000))
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 1000
    # every 4th token repeats the one 3 before it
    assert np.array_equal(a[:, 4::4], a[:, 1:-3:4])


def test_train_batches_repeat_and_all_differ():
    mix = dict(TRAIN, batch=2, seq=16, batches=5)
    one = traffic.train_batches(mix, SEED, 500)
    two = traffic.train_batches(mix, SEED, 500)
    for (t1, y1), (t2, y2) in zip(one, two):
        assert np.array_equal(t1, t2) and np.array_equal(y1, y2)
        assert np.array_equal(t1[:, 1:], y1[:, :-1])
    rows = {t.tobytes() for t, _ in one}
    assert len(rows) == len(one)


def test_waves_repeat_for_a_seed():
    for k in (0, 5, 40, -1):
        a = traffic.wave_prompts(PREFILL, SEED, k, 1000)
        b = traffic.wave_prompts(PREFILL, SEED, k, 1000)
        assert len(a) == PREFILL["wave"]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_every_seed_gets_the_same_waves_in_another_order():
    # wave by wave the same lengths for every seed, so any prefix of the
    # waves (what a window runs) is the same work; the seed orders the
    # prompts inside a wave
    c = PREFILL["cycle_waves"]
    got = [[sorted(traffic.wave_lengths(PREFILL, s, k)) for k in range(2 * c + 3)]
           for s in (SEED, 7, 2 ** 33 + 5)]
    assert got[0] == got[1] == got[2]
    assert got[0][:c] == got[0][c:2 * c]
    orders = [[traffic.wave_lengths(PREFILL, s, k) for k in range(c)]
              for s in (SEED, 7)]
    assert orders[0] != orders[1]


def test_a_window_takes_the_drawn_waves_in_turn():
    # set-up draws whole cycles; a window past the last wave starts again
    # at the first, which has the lengths the generator gives that wave
    mix = dict(PREFILL, waves=2 * PREFILL["cycle_waves"])
    drawn = traffic.window_waves(mix, SEED, 1000)
    assert len(drawn) == mix["waves"]
    for k in (0, 7, mix["waves"] + 3, 3 * mix["waves"] + 1):
        assert ([len(p) for p in drawn[k % len(drawn)]]
                == traffic.wave_lengths(mix, SEED, k % len(drawn)))
        assert (sorted(traffic.wave_lengths(mix, SEED, k % len(drawn)))
                == sorted(traffic.wave_lengths(mix, SEED, k)))
    with pytest.raises(ValueError):
        traffic.window_waves(dict(mix, waves=mix["waves"] + 1), SEED, 1000)


def test_wave_lengths_follow_the_mix():
    lay = traffic.wave_layout(PREFILL)
    lo, hi = PREFILL["length"]["min"], PREFILL["length"]["max"]
    assert lay.min() >= lo and lay.max() == hi
    real, padded = lay.sum(), (PREFILL["wave"] * lay.max(1)).sum()
    # the mix's own arithmetic: ~14,200 real tokens and ~47 % padding a wave
    assert 13500 < real / len(lay) < 15000
    assert 0.44 < 1 - real / padded < 0.51
    assert max(traffic.warmup_lengths(PREFILL, SEED)) == hi


def test_weights_repeat_and_redraw_leaf_by_leaf():
    a = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab_size": 130, "qkv_bias": True}
    one = W.draw(a, SEED, "cpu", torch.bfloat16)
    two = W.draw(a, SEED, "cpu", torch.bfloat16)
    for i, spec in enumerate(W.leaf_specs(a)):
        x = W.get(one, spec[0])
        assert torch.equal(x, W.get(two, spec[0]))
        assert torch.equal(x, W.draw_leaf(spec, i, SEED, "cpu", torch.bfloat16))
        assert x.dtype == torch.bfloat16
    assert one["embed"]["embedding"].shape == (256, 8)
    assert one["embed"]["unembed"].shape == (8, 256)
    other = W.draw(a, SEED + 1, "cpu", torch.bfloat16)
    assert not torch.equal(one["blocks"]["attn"]["wq"],
                           other["blocks"]["attn"]["wq"])


def test_a_tied_table_is_drawn_at_the_unembeddings_scale():
    a = {"num_layers": 1, "d_model": 64, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 32, "d_ff": 16, "vocab_size": 1000}
    untied = W.draw(a, SEED, "cpu", torch.float32)["embed"]
    tied = W.draw(dict(a, tie_embeddings=True), SEED, "cpu", torch.float32)["embed"]
    assert set(tied) == {"embedding"}
    assert float(untied["embedding"].std()) == pytest.approx(1.0, rel=0.05)
    assert float(tied["embedding"].std()) == pytest.approx(64 ** -0.5, rel=0.05)
    assert float(untied["unembed"].std()) == pytest.approx(64 ** -0.5, rel=0.05)
