"""Decoder-only transformer language model, pre-LN (the port of
``block`` and ``build`` in ``paddle_tpu/models/transformer.py``).

Parameter names are the JAX package's (``blk0_attn.wq``,
``blk0_ffn_up.w0``, ``lm_head.b`` ...), so a JAX ``Parameters`` tar loads
into the port's topology as it is.  Not yet ported: ``remat``,
``fused_head`` (``lm_head_cost``), mixture-of-experts blocks, dropout,
the encoder-decoder ``build_seq2seq`` and the decoding helpers; asking
for them raises.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.platform.enforce import enforce_that


def block(x, *, n_heads: int, ffn_mult: int = 4, name: str,
          causal: bool = True):
    """One pre-LN block: x + MHA(LN(x)); x + FFN(LN(x)), FFN = fc(gelu)
    then fc."""
    a = layer.layer_norm(x, name=f"{name}_ln1")
    a = layer.multi_head_attention(a, num_heads=n_heads, causal=causal,
                                   name=f"{name}_attn")
    x = layer.addto(input=[x, a], name=f"{name}_res1")
    f = layer.layer_norm(x, name=f"{name}_ln2")
    f = layer.fc(input=f, size=x.size * ffn_mult, act="gelu",
                 name=f"{name}_ffn_up")
    f = layer.fc(input=f, size=x.size, name=f"{name}_ffn_down")
    return layer.addto(input=[x, f], name=f"{name}_res2")


def build(vocab_size: int = 32768, d_model: int = 512, n_layers: int = 6,
          n_heads: int = 8, max_len: int = 1024, ffn_mult: int = 4,
          dropout: float = 0.0, fused_head: bool = False,
          moe_experts: int = 0, remat: bool = False):
    """Returns (tokens, positions, target, logits, cost).

    Feeds: ``tokens`` / ``target`` are integer sequences (next-token
    targets), ``pos`` is the 0-based position within each sequence."""
    for flag, what in ((dropout > 0.0, "dropout"),
                       (fused_head, "fused_head (lm_head_cost)"),
                       (moe_experts > 0, "moe_experts"), (remat, "remat")):
        enforce_that(not flag, f"{what} is not ported yet",
                     context="transformer")
    tokens = layer.data(name="tokens",
                        type=data_type.integer_value_sequence(vocab_size))
    pos = layer.data(name="pos",
                     type=data_type.integer_value_sequence(max_len))
    target = layer.data(name="target",
                        type=data_type.integer_value_sequence(vocab_size))
    tok_emb = layer.embedding(input=tokens, size=d_model, name="tok_embed")
    pos_emb = layer.embedding(input=pos, size=d_model, name="pos_embed")
    x = layer.addto(input=[tok_emb, pos_emb], name="embed_sum")
    for i in range(n_layers):
        x = block(x, n_heads=n_heads, ffn_mult=ffn_mult, name=f"blk{i}")
    x = layer.layer_norm(x, name="final_ln")
    logits = layer.fc(input=x, size=vocab_size, name="lm_head")
    cost = layer.classification_cost(input=logits, label=target)
    return tokens, pos, target, logits, cost
