"""The yardstick's operation and byte counts against hand counts."""
from bench import flops, peaks

TINY = {"family": "dense", "num_hidden_layers": 2, "hidden_size": 4,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2,
        "intermediate_size": 8, "vocab_size": 10,
        "hidden_act": "gelu_pytorch_tanh"}


def test_k7_causal_and_bidir():
    # causal 2x2, one head of width 1: key pairs 1 + 2 = 3
    assert flops.k7_work((1, 1, 1, 2, 2, 1), "causal") == (12, 32)
    # q and o 3x2x4 each, k and v 5x1x4 each, 15 pairs
    assert flops.k7_work((1, 2, 1, 3, 5, 4), "bidir") == (
        4 * 2 * 4 * 15, 4 * (2 * 3 * 2 * 4 + 2 * 5 * 4))
    # a causal block of 2 queries at the end of 4 keys: 3 + 4 pairs
    assert flops.k7_work((1, 1, 1, 2, 4, 1), "causal")[0] == 4 * 7


def test_k8_reads_live_positions_only():
    # rows with 3 and 5 live positions, 2 heads over 1 KV head, d 4
    ops, nbytes = flops.k8_work((2, 2, 1, 8, 4), [3, 5])
    assert ops == 4 * 2 * 4 * 8
    assert nbytes == 4 * (2 * 2 * 2 * 4 + 2 * 1 * 4 * 8) + 4 * 2


def test_layer_weights_dense_and_moe():
    # q 4x4, k and v 4x2 each, o 4x4, mlp 2 x 4x8
    assert flops.layer_weights(TINY) == 16 + 16 + 16 + 64
    moe = dict(TINY, family="moe", num_experts=4, num_experts_per_tok=2,
               hidden_act="silu")
    # router 4x4 and 2 of 4 experts of 3 matrices 4x8
    assert flops.layer_weights(moe) == 48 + 16 + 2 * 3 * 32


def test_model_flops_by_hand():
    body = 2 * 2 * 112  # 2 layers of 112 weights, 2 FLOPs each
    head = 2 * 4 * 10
    att = 4 * 2 * 2 * 2  # QK and PV, 2 layers, 2 heads of 2, per key
    # 3 prompt tokens (contexts 1, 2, 3), 2 served tokens: the head twice
    # and one more step at context 4
    want = 3 * body + att * (1 + 2 + 3) + 2 * head + body + att * 4
    assert flops.model_flops(TINY, [(3, 2)]) == want
    assert flops.model_flops(TINY, [(3, 1)]) == \
        3 * body + att * 6 + head


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert flops.bound_s(989e12, 0, peaks.DENSE_TENSOR_FLOPS,
                         peaks.HBM_BYTES_PER_S) == 1.0
    assert flops.bound_s(0, 3.35e12, peaks.DENSE_TENSOR_FLOPS,
                         peaks.HBM_BYTES_PER_S) == 1.0
