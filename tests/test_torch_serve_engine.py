"""The port's continuous-batching server against the reference's
(``repro.serve.engine``) on carried weights, on the CPU: the scenarios of
``tests/test_serve.py`` (greedy ``serve_batch``, continuous batching,
mixed budgets, FIFO backfill, dead slots, one round equal to
``serve_batch``), each with the reference's tokens token for token and its
``decode_steps`` / ``prefill_rounds``; and one ``ServeEngine`` each for
the SSM, encoder-decoder, VLM and hybrid families.  The SSM families'
prompts keep every prefill's S a multiple of ``min(ssm_chunk, S)`` (the
reference asserts it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
from repro.serve import engine as ref_engine
from repro_torch.serve import engine as port_engine


@pytest.fixture(scope="module")
def qwen():
    return parity.models("qwen2.5-3b")


def _both(models, batch_size, max_seq, reqs, extra=None):
    """Run ``reqs`` ((prompt, budget) pairs) through both packages'
    ``ServeEngine``; returns the two engines and finished lists."""
    rm, rp, pm, pp = models
    rextra = pextra = None
    if extra is not None:
        rextra = {k: jnp.asarray(v) for k, v in extra.items()}
        pextra = {k: torch.from_numpy(v) for k, v in extra.items()}
    r_eng = ref_engine.ServeEngine(rm, rp, batch_size, max_seq, extra=rextra)
    p_eng = port_engine.ServeEngine(pm, pp, batch_size, max_seq,
                                    extra=pextra)
    for i, (prompt, budget) in enumerate(reqs):
        r_eng.submit(ref_engine.Request(uid=i, prompt=prompt,
                                        max_new_tokens=budget))
        p_eng.submit(port_engine.Request(uid=i, prompt=prompt,
                                         max_new_tokens=budget))
    return r_eng, r_eng.run(), p_eng, p_eng.run()


def _assert_same(r_eng, r_done, p_eng, p_done):
    assert [r.uid for r in p_done] == [r.uid for r in r_done]
    assert [r.out_tokens for r in p_done] == [r.out_tokens for r in r_done]
    assert all(r.done for r in p_done)
    assert p_eng.decode_steps == r_eng.decode_steps
    assert p_eng.prefill_rounds == r_eng.prefill_rounds


def test_serve_batch_greedy_matches_the_reference():
    rm, rp, pm, pp = parity.models("llama3-8b")
    prompts = [np.arange(5, dtype=np.int32), np.arange(3, 8, dtype=np.int32)]
    want = ref_engine.serve_batch(rm, rp, prompts, max_new_tokens=4,
                                  max_seq=16)
    got = port_engine.serve_batch(pm, pp, prompts, max_new_tokens=4,
                                  max_seq=16)
    assert got == want
    assert len(got) == 2 and all(len(o) == 4 for o in got)
    assert all(0 <= t < pm.cfg.padded_vocab for o in got for t in o)


def test_engine_continuous_batching_matches_the_reference(qwen):
    out = _both(qwen, 2, 16, [(np.arange(4, dtype=np.int32) + i, 3)
                              for i in range(5)])
    _assert_same(*out)
    assert len(out[3]) == 5
    assert all(len(r.out_tokens) == 3 for r in out[3])


def test_engine_mixed_budgets_stop_at_own_limit(qwen):
    budgets = [1, 5, 3, 2]
    r_eng, r_done, p_eng, p_done = _both(
        qwen, 2, 32, [(np.arange(4, dtype=np.int32) + i, b)
                      for i, b in enumerate(budgets)])
    _assert_same(r_eng, r_done, p_eng, p_done)
    assert {r.uid: len(r.out_tokens) for r in p_done} == \
        {i: b for i, b in enumerate(budgets)}
    assert p_eng.decode_steps <= sum(budgets)
    assert p_eng.prefill_rounds <= len(budgets)


def test_engine_backfill_is_fifo(qwen):
    out = _both(qwen, 2, 16, [(np.arange(3, dtype=np.int32) + i, 2)
                              for i in range(4)])
    _assert_same(*out)
    assert [r.uid for r in out[3]] == [0, 1, 2, 3]


def test_engine_underfull_batch_pads_with_dead_slots(qwen):
    r_eng, r_done, p_eng, p_done = _both(
        qwen, 4, 16, [(np.arange(5, dtype=np.int32), 3)])
    _assert_same(r_eng, r_done, p_eng, p_done)
    assert len(p_done) == 1 and len(p_done[0].out_tokens) == 3
    assert p_eng.prefill_rounds == 1 and p_eng.decode_steps == 2


def test_engine_single_round_matches_serve_batch(qwen):
    _, _, pm, pp = qwen
    prompts = [np.arange(5, dtype=np.int32), np.arange(3, 8, dtype=np.int32)]
    want = port_engine.serve_batch(pm, pp, prompts, max_new_tokens=4,
                                   max_seq=16)
    r_eng, r_done, p_eng, p_done = _both(qwen, 2, 16,
                                         [(p, 4) for p in prompts])
    _assert_same(r_eng, r_done, p_eng, p_done)
    assert [r.out_tokens for r in sorted(p_done, key=lambda r: r.uid)] \
        == want


def test_engine_zero_budget_retires_without_work(qwen):
    r_eng, r_done, p_eng, p_done = _both(
        qwen, 2, 16, [(np.arange(4, dtype=np.int32), 0),
                      (np.arange(4, dtype=np.int32) + 1, 2)])
    _assert_same(r_eng, r_done, p_eng, p_done)
    assert [len(r.out_tokens) for r in p_done] == [0, 2]


def _stub(cfg, B, seed=4):
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    return None


@pytest.mark.parametrize("arch", ["mamba2-130m", "whisper-small",
                                  "internvl2-76b", "jamba-v0.1-52b"])
def test_engine_serves_each_family_as_the_reference(arch):
    """Three requests through two slots (two rounds, the second a
    re-prefill of one request): prompts of 4-6 tokens keep each prefill's
    S below the smoke chunk of 8; the VLM's cache covers its 8 patches."""
    models = parity.models(arch)
    cfg = models[0].cfg
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 3)
            for n in (4, 5, 6)]
    out = _both(models, 2, 32, reqs, extra=_stub(cfg, 2))
    _assert_same(*out)
    assert out[2].prefill_rounds == 2
