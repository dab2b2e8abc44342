"""Attention seq2seq NMT (the port of ``paddle_tpu/models/seq2seq.py``;
reference: PaddlePaddle's demo/seqToseq, BASELINE config #3).

``build_train`` and ``build_generator`` build separate topologies whose
parameter keys coincide (the JAX model's layer and parameter names), so
parameters trained with the first generate with the second.  The encoder
is a forward and a reverse ``simple_gru`` over the source embedding; the
decoder a ``recurrent_group`` (training) or a ``beam_search``
(generation) over one step: ``simple_attention`` on the encoding, an fc of
the context and the previous target token, ``gru_step``, and a softmax
over the target vocabulary.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer, networks
from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.generation import GeneratedInput, beam_search


def _encoder(src_dict_size: int, embed_size: int, hidden: int):
    src = layer.data(name="source_words",
                     type=data_type.integer_value_sequence(src_dict_size))
    emb = layer.embedding(input=src, size=embed_size, name="src_emb",
                          param_attr=ParamAttr(name="_src_emb"))
    fwd = networks.simple_gru(input=emb, size=hidden, name="enc_fwd")
    bwd = networks.simple_gru(input=emb, size=hidden, reverse=True,
                              name="enc_bwd")
    encoded = layer.concat(input=[fwd, bwd], name="encoded")
    enc_proj = layer.fc(input=encoded, size=hidden, bias_attr=False,
                        name="enc_proj")
    boot = layer.fc(input=layer.first_seq(input=bwd, name="bwd_first"),
                    size=hidden, act="tanh", name="decoder_boot")
    return src, encoded, enc_proj, boot


def _decoder_step(hidden: int, trg_dict_size: int, boot):
    """step(token_emb, enc_seq, enc_proj) with stable layer names."""

    def step(token_emb, enc_seq, enc_proj):
        dec_mem = layer.memory(name="gru_out", size=hidden, boot_layer=boot)
        context = networks.simple_attention(
            encoded_sequence=enc_seq, encoded_proj=enc_proj,
            decoder_state=dec_mem, name="att")
        x = layer.fc(input=[context, token_emb], size=hidden * 3,
                     bias_attr=True, name="dec_in")
        gru = layer.gru_step(input=x, output_mem=dec_mem, size=hidden,
                             name="gru_out")
        return layer.fc(input=gru, size=trg_dict_size, act="softmax",
                        name="dec_out")

    return step


def build_train(src_dict_size: int = 1000, trg_dict_size: int = 1000,
                embed_size: int = 64, hidden: int = 64):
    """(cost, probs_seq).  Feeds: ``source_words``, ``target_words``
    (``<s>`` + target) and ``target_next`` (target + ``<e>``)."""
    src, encoded, enc_proj, boot = _encoder(src_dict_size, embed_size,
                                            hidden)
    trg = layer.data(name="target_words",
                     type=data_type.integer_value_sequence(trg_dict_size))
    trg_next = layer.data(name="target_next",
                          type=data_type.integer_value_sequence(
                              trg_dict_size))
    trg_emb = layer.embedding(input=trg, size=embed_size, name="trg_emb",
                              param_attr=ParamAttr(name="_trg_emb"))
    probs_seq = layer.recurrent_group(
        step=_decoder_step(hidden, trg_dict_size, boot),
        input=[trg_emb, layer.StaticInput(encoded),
               layer.StaticInput(enc_proj)],
        name="decoder_group")
    cost = layer.cross_entropy_cost(input=probs_seq, label=trg_next,
                                    name="nmt_cost")
    return cost, probs_seq


def build_generator(src_dict_size: int = 1000, trg_dict_size: int = 1000,
                    embed_size: int = 64, hidden: int = 64,
                    bos_id: int = 0, eos_id: int = 1, beam_size: int = 4,
                    max_length: int = 25, **hooks):
    """The beam-search node over the same step; evaluate it with
    ``Inference``.  ``hooks`` go to ``beam_search`` (``candidate_adjust``,
    ``host_candidate_adjust``, ``path_filter``, ``stop_condition``)."""
    src, encoded, enc_proj, boot = _encoder(src_dict_size, embed_size,
                                            hidden)
    return beam_search(
        step=_decoder_step(hidden, trg_dict_size, boot),
        input=[GeneratedInput(size=trg_dict_size, embedding_name="_trg_emb",
                              embedding_size=embed_size),
               layer.StaticInput(encoded), layer.StaticInput(enc_proj)],
        bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
        max_length=max_length, name="nmt_beam", **hooks)
