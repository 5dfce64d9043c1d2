"""``counts.py`` against FLOPs and bytes worked out by hand for one small
shape."""

import pytest

from portbench import counts

# D 8, 2 heads of 4, 1 KV head, MLP 16, vocab 10, 3 layers
DENSE = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
         "d_ff": 16, "vocab_size": 10, "num_layers": 3}
MOE = dict(DENSE, num_experts=4, experts_per_token=2, moe_d_ff=6)


def test_layer_params_by_hand():
    # wq 8·8 + wk 8·4 + wv 8·4 + wo 8·8 = 192; MLP 3·8·16 = 384
    assert counts.attn_params(DENSE) == 192
    assert counts.layer_params(DENSE) == 576
    # router 8·4 = 32; two active experts 2·3·8·6 = 288, all four 576
    assert counts.layer_params(MOE) == 192 + 32 + 288
    assert counts.layer_params(MOE, active=False) == 192 + 32 + 576


def test_prefill_flops_by_hand():
    # 2 prompts of 5: 10 tokens · 2 · 3 layers · 576 = 34560; head on the
    # last position of each: 2 · 80 · 2 = 320; causal pairs 2 · 15 = 30,
    # each 4 · 4 · 2 heads · 3 layers = 96 → 2880
    assert counts.prefill_flops(DENSE, 2, 5) == 34560 + 320 + 2880


def test_decode_flops_and_bytes_by_hand():
    # 2 sequences over 7 cached keys: 2 · 3 · 576 · 2 = 6912; head 320;
    # pairs 2 · 8 = 16 → 16 · 96 = 1536
    assert counts.decode_flops(DENSE, 2, 7) == 6912 + 320 + 1536
    # weights (3 · 576 + 80) · 2 B = 3616; K and V of a position:
    # 2 · 1 · 4 · 2 B · 3 layers = 48 B, read for 7 and written for 1
    # position of 2 sequences: 48 · 2 · 8 = 768
    assert counts.decode_bytes(DENSE, 2, 7) == 3616 + 768
    # the MoE with one expert a layer touched: (192 + 32 + 144) · 3 + 80
    assert counts.decode_bytes(MOE, 2, 7, experts_touched=1) == \
        ((192 + 32 + 144) * 3 + 80) * 2 + 768


def test_flash_work_and_bound_by_hand():
    # [1, 4, 2, 1, 4]: pairs 10, FLOPs 4·4·10·2 = 320; q and o 2·4·2·4,
    # k and v 2·4·1·4, in bf16: 2 · (64 + 32) = 192
    assert counts.flash_work(1, 4, 2, 1, 4) == (320, 192)
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
