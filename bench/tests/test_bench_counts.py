"""The FLOP and byte counts against hand counts at a small shape."""
import pytest

from yardstick import counts

A = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
     "head_dim": 4, "d_ff": 16, "vocab_size": 130}
MOE = dict(A, num_experts=4, experts_per_token=2)


def test_parameters_in_products():
    # q 8x8, k and v 8x4 each, o 8x8; the MLP 3 x 8x16
    assert counts.attn_params(A) == 64 + 32 + 32 + 64
    assert counts.block_params(A) == 192 + 384
    assert counts.unembed_params(A) == 8 * 256       # vocab rounded to 128
    # the router 8x4 and two experts of 3 x 8x16
    assert counts.block_params(MOE) == 192 + 32 + 2 * 384


def test_train_step_flops_by_hand():
    B, S = 2, 3
    pairs = 6                                        # 1 + 2 + 3
    dense = 6 * (2 * 576 + 2048) * B * S
    attn = 12 * 4 * 2 * 2 * B * pairs                # 12 D, heads, layers
    assert counts.train_step_flops(A, B, S) == dense + attn


def test_prefill_flops_count_real_positions_only():
    lengths = [3, 1]
    tokens, pairs = 4, 6 + 1
    want = 2 * 2 * 576 * tokens + 4 * 4 * 2 * 2 * pairs + 2 * 2048 * 2
    assert counts.prefill_flops(A, lengths) == want


def test_flash_counts_by_hand():
    f, b = counts.flash_fwd_call(A, [3, 1])
    assert f == 4 * 4 * 2 * 7
    assert b == 4 * (2 * 2 + 2 * 1) * 4 * 2          # Q, O, K, V in bf16
    f, b = counts.flash_bwd_call(A, [2])
    assert f == 8 * 4 * 2 * 3
    assert b == 2 * ((3 * 2 + 2) * 4 * 2 + 2 * 4 + (2 + 2) * 4 * 2)


def test_roofline_share_takes_the_larger_bound():
    assert counts.roofline_share(989e12, 0, 2.0, 989e12, 1e12) == \
        pytest.approx(50.0)
    assert counts.roofline_share(0, 3e12, 1.0, 989e12, 1e12) == \
        pytest.approx(300.0)
    assert counts.roofline_share(1.0, 1.0, 0.0, 1, 1) is None
