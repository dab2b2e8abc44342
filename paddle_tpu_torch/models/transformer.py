"""Transformer models, pre-LN (the port of ``paddle_tpu/models/
transformer.py``): the decoder-only LM ``build`` (with dropout, the fused
LM head ``fused_head`` and per-block rematerialization ``remat``), the
encoder-decoder translation model ``build_seq2seq``, and decoding from
the trainer's own parameter dict: ``generate`` (greedy or temperature),
``beam_generate`` and ``beam_generate_batch`` over dense per-layer K/V
caches, with the functional block ``block_apply`` and ``stage_params``.

Parameter names are the JAX package's (``blk0_attn.wq``,
``blk0_ffn_up.w0``, ``lm_head.b``, ``dec0_cross.wq`` ...), so a JAX
``Parameters`` tar loads into the port's topology as it is.  Mixture-of-
experts blocks (``moe_experts > 0``) swap each block's FFN for
``layer.moe_ffn`` and make the cost a list: the cross-entropy, then one
load-balance aux cost a block.

Decoding runs a Python loop over the steps, one token a step (the JAX
package's ``lax.scan``): the prompt is fed one token at a time, as the
scan feeds it.  The step is JAX's ``_step_token``: plain products in the
parameters' dtype (not the bf16 policy), attention as an f32 product over
the whole cache with positions after the step masked to -1e30, layer norm
with f32 statistics and the tanh GELU.  The decoders take the parameter
dict as JAX's do (``Parameters.as_dict()``, or ``{name: array}`` of numpy
arrays or tensors) and run on ``device`` (``cuda`` unless asked).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch import topology as _topo
from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.generation import BeamState, _top_k_stable
from paddle_tpu_torch.ops import math as pmath
from paddle_tpu_torch.ops.attention import flash_attention
from paddle_tpu_torch.ops.norm import layer_norm
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import enforce_that

NEG = -1e30    # a masked score or a dropped beam (the JAX module's NEG)


def block(x, *, n_heads: int, ffn_mult: int = 4, name: str,
          dropout: float = 0.0, causal: bool = True, memory=None,
          moe_experts: int = 0, moe_top_k: int = 1):
    """One pre-LN block: x + drop(MHA(LN(x))) [+ x + drop(cross-MHA(LN(x),
    memory)) when ``memory`` is given]; x + drop(FFN(LN(x))), FFN =
    fc(gelu) then fc.  ``causal=False`` is the encoder block; ``memory``
    adds the cross-attention sub-block of ``build_seq2seq``'s decoder
    (its norm and residual take index 2, the FFN's 3).  With
    ``moe_experts > 0`` the FFN is ``layer.moe_ffn`` (expert width
    ``ffn_mult`` times the model's) and the block returns ``(out, aux)``."""
    idx = 1
    a = layer.layer_norm(x, name=f"{name}_ln{idx}")
    a = layer.multi_head_attention(a, num_heads=n_heads, causal=causal,
                                   name=f"{name}_attn")
    if dropout > 0.0:
        a = layer.dropout(a, dropout, name=f"{name}_attn_drop")
    x = layer.addto(input=[x, a], name=f"{name}_res{idx}")
    if memory is not None:
        idx += 1
        c = layer.layer_norm(x, name=f"{name}_ln{idx}")
        c = layer.multi_head_attention(c, key=memory, num_heads=n_heads,
                                       causal=False, name=f"{name}_cross")
        if dropout > 0.0:
            c = layer.dropout(c, dropout, name=f"{name}_cross_drop")
        x = layer.addto(input=[x, c], name=f"{name}_res{idx}")
    idx += 1
    f = layer.layer_norm(x, name=f"{name}_ln{idx}")
    aux = None
    if moe_experts > 0:
        f, aux = layer.moe_ffn(f, num_experts=moe_experts,
                               expert_hidden=x.size * ffn_mult,
                               top_k=moe_top_k, name=f"{name}_moe")
    else:
        f = layer.fc(input=f, size=x.size * ffn_mult, act="gelu",
                     name=f"{name}_ffn_up")
        f = layer.fc(input=f, size=x.size, name=f"{name}_ffn_down")
    if dropout > 0.0:
        f = layer.dropout(f, dropout, name=f"{name}_ffn_drop")
    out = layer.addto(input=[x, f], name=f"{name}_res{idx}")
    return (out, aux) if moe_experts > 0 else out


def build(vocab_size: int = 32768, d_model: int = 512, n_layers: int = 6,
          n_heads: int = 8, max_len: int = 1024, ffn_mult: int = 4,
          dropout: float = 0.0, fused_head: bool = False,
          moe_experts: int = 0, moe_top_k: int = 1, remat: bool = False):
    """Returns (tokens, positions, target, logits, cost).

    Feeds: ``tokens`` / ``target`` are integer sequences (next-token
    targets), ``pos`` is the 0-based position within each sequence.

    ``fused_head=True`` swaps the fc(vocab) -> classification_cost pair
    for ``layer.lm_head_cost`` (blockwise online logsumexp: the [tokens,
    vocab] logits never exist whole); it shares the fc's parameter names
    ``lm_head.w0``/``lm_head.b``, and the returned ``logits`` node still
    computes the logits for decoding.  ``remat=True`` runs each block as
    one ``topology.remat_scope`` segment: the backward recomputes its
    activations from the block's input (dropout masks included).
    ``moe_experts > 0`` builds mixture-of-experts blocks (``moe_top_k``
    1 or 2) and returns the cost as ``[xent] + one aux cost a block``:
    pass the list to ``SGD(cost=...)``."""
    tokens = layer.data(name="tokens",
                        type=data_type.integer_value_sequence(vocab_size))
    pos = layer.data(name="pos",
                     type=data_type.integer_value_sequence(max_len))
    target = layer.data(name="target",
                        type=data_type.integer_value_sequence(vocab_size))
    tok_emb = layer.embedding(input=tokens, size=d_model, name="tok_embed")
    pos_emb = layer.embedding(input=pos, size=d_model, name="pos_embed")
    x = layer.addto(input=[tok_emb, pos_emb], name="embed_sum")
    aux_nodes = []
    for i in range(n_layers):
        scope = (_topo.remat_scope(f"blk{i}") if remat
                 else contextlib.nullcontext())
        with scope:
            if moe_experts > 0:
                x, aux = block(x, n_heads=n_heads, ffn_mult=ffn_mult,
                               name=f"blk{i}", dropout=dropout,
                               moe_experts=moe_experts, moe_top_k=moe_top_k)
                aux_nodes.append(aux)
            else:
                x = block(x, n_heads=n_heads, ffn_mult=ffn_mult,
                          name=f"blk{i}", dropout=dropout)
    x = layer.layer_norm(x, name="final_ln")
    logits = layer.fc(input=x, size=vocab_size, name="lm_head")
    if fused_head:
        cost = layer.lm_head_cost(x, target, vocab_size=vocab_size,
                                  param_attr=ParamAttr(name="lm_head.w0"),
                                  bias_attr=ParamAttr(name="lm_head.b"),
                                  name="lm_head_fused")
    else:
        cost = layer.classification_cost(input=logits, label=target)
    if moe_experts > 0:
        cost = [cost] + aux_nodes
    return tokens, pos, target, logits, cost


def build_seq2seq(src_vocab: int = 30000, trg_vocab: int = 30000,
                  d_model: int = 256, n_layers: int = 3, n_heads: int = 4,
                  max_len: int = 256, ffn_mult: int = 4):
    """Encoder-decoder transformer for translation: non-causal encoder
    blocks, then decoder blocks with causal self-attention and
    cross-attention over the encoder's memory (``multi_head_attention``
    with ``key=``: the decoder's packed queries against the sources'
    packed keys, sequence i against sequence i).

    Returns (src, src_pos, trg, trg_pos, label, logits, cost).  Feeds:
    ``trg`` is the shifted-right target, ``label`` the gold next
    tokens."""
    src = layer.data(name="src",
                     type=data_type.integer_value_sequence(src_vocab))
    src_pos = layer.data(name="src_pos",
                         type=data_type.integer_value_sequence(max_len))
    trg = layer.data(name="trg",
                     type=data_type.integer_value_sequence(trg_vocab))
    trg_pos = layer.data(name="trg_pos",
                         type=data_type.integer_value_sequence(max_len))
    label = layer.data(name="label",
                       type=data_type.integer_value_sequence(trg_vocab))

    enc = layer.addto(input=[
        layer.embedding(input=src, size=d_model, name="src_embed"),
        layer.embedding(input=src_pos, size=d_model, name="src_pos_embed"),
    ], name="enc_embed_sum")
    for i in range(n_layers):
        enc = block(enc, n_heads=n_heads, ffn_mult=ffn_mult,
                    name=f"enc{i}", causal=False)
    memory = layer.layer_norm(enc, name="enc_final_ln")

    dec = layer.addto(input=[
        layer.embedding(input=trg, size=d_model, name="trg_embed"),
        layer.embedding(input=trg_pos, size=d_model, name="trg_pos_embed"),
    ], name="dec_embed_sum")
    for i in range(n_layers):
        dec = block(dec, n_heads=n_heads, ffn_mult=ffn_mult,
                    name=f"dec{i}", causal=True, memory=memory)
    dec = layer.layer_norm(dec, name="dec_final_ln")
    logits = layer.fc(input=dec, size=trg_vocab, name="trg_head")
    cost = layer.classification_cost(input=logits, label=label)
    return src, src_pos, trg, trg_pos, label, logits, cost


# ---------------------------------------------------------------------------
# decoding over dense K/V caches, from the trainer's parameter dict
# ---------------------------------------------------------------------------

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


def _ln(x, g, b):
    """The training graph's normalization (f32 statistics, emitted in
    x's dtype)."""
    return layer_norm(x, g, b)


def _step_token(p, x_t, caches: Caches, t: int, *, n_layers: int,
                n_heads: int, max_len: int):
    """One decode step for embeddings ``x_t`` [..., d] (any leading
    rows: beams, prompts); returns (hidden [..., d], caches).

    caches: one (k, v) a layer, each [..., max_len, H, Dh]; this step
    writes position ``t`` in place, and positions after ``t`` are masked
    out of the softmax."""
    d = x_t.shape[-1]
    head_dim = d // n_heads
    lead = x_t.shape[:-1]
    mask = torch.arange(max_len, device=x_t.device) <= t
    for i in range(n_layers):
        k_cache, v_cache = caches[i]
        a_in = _ln(x_t, p[f"blk{i}_ln1.gamma"], p[f"blk{i}_ln1.beta"])
        q = (a_in @ p[f"blk{i}_attn.wq"]).reshape(*lead, n_heads, head_dim)
        k_cache[..., t, :, :] = (a_in @ p[f"blk{i}_attn.wk"]).reshape(
            *lead, n_heads, head_dim)
        v_cache[..., t, :, :] = (a_in @ p[f"blk{i}_attn.wv"]).reshape(
            *lead, n_heads, head_dim)
        scores = torch.einsum("...hd,...shd->...hs", q.float(),
                              k_cache.float()) / math.sqrt(head_dim)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("...hs,...shd->...hd", probs,
                           v_cache.float()).reshape(*lead, d)
        x_t = x_t + ctx.to(x_t.dtype) @ p[f"blk{i}_attn.wo"]
        f_in = _ln(x_t, p[f"blk{i}_ln2.gamma"], p[f"blk{i}_ln2.beta"])
        h = F.gelu(f_in @ p[f"blk{i}_ffn_up.w0"] + p[f"blk{i}_ffn_up.b"],
                   approximate="tanh")
        x_t = x_t + (h @ p[f"blk{i}_ffn_down.w0"] + p[f"blk{i}_ffn_down.b"])
    return x_t, caches


def _new_caches(p, lead: Tuple[int, ...], n_layers: int, n_heads: int,
                max_len: int) -> Caches:
    """Zeroed f32 (k, v) caches [*lead, max_len, H, Dh] a layer."""
    d = p["tok_embed.w"].shape[1]
    shape = tuple(lead) + (max_len, n_heads, d // n_heads)
    dev = p["tok_embed.w"].device
    return [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
            for _ in range(n_layers)]


def _embed(p, tok, t: int):
    return p["tok_embed.w"][tok] + p["pos_embed.w"][t]


def _logits(p, h):
    """The head over a step's hidden state, in f32."""
    h = _ln(h, p["final_ln.gamma"], p["final_ln.beta"])
    return (h @ p["lm_head.w0"] + p["lm_head.b"]).float()


def _as_tensor(v, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(dev)
    # a copy: arrays read from JAX are not writable
    return torch.from_numpy(np.array(v, copy=True)).to(dev)


def _prep_decode(params, prompt_ids, max_new_tokens, max_len, fn_name,
                 device: DeviceLike = None):
    """(parameters on the device, prompt ids, prompt length, total
    length), with the JAX package's checks."""
    dev = resolve_device(device)
    prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
    n_prompt = int(prompt.shape[0])
    if n_prompt < 1:
        raise ValueError(f"{fn_name}() needs a non-empty prompt")
    total = n_prompt + int(max_new_tokens)
    if total > max_len:
        raise ValueError(f"prompt+new = {total} exceeds max_len {max_len}")
    p = {k: _as_tensor(v, dev) for k, v in dict(params).items()}
    return p, prompt.tolist(), n_prompt, total


def _generator(rng, dev: torch.device) -> torch.Generator:
    """``rng``: a ``torch.Generator`` on the device, or a seed (None: 0)."""
    if isinstance(rng, torch.Generator):
        enforce_that(rng.device.type == dev.type,
                     f"rng is a generator on {rng.device}, the decode on "
                     f"{dev}", context="generate")
        return rng
    return torch.Generator(device=dev).manual_seed(
        0 if rng is None else int(rng))


@torch.no_grad()
def generate(params, prompt_ids, max_new_tokens: int, *, n_layers: int,
             n_heads: int, max_len: int = 1024, temperature: float = 0.0,
             rng=None, eos_id: int = -1, device: DeviceLike = None):
    """Greedy (``temperature`` 0) or temperature decode continuing
    ``prompt_ids``.

    params: the trainer's parameter dict (``Parameters.as_dict()`` or a
    plain {name: array}).  Returns an int32 array of the generated ids
    (length ``max_new_tokens``; positions after an ``eos_id`` repeat
    it).  A temperature draw is the Gumbel-max of ``logits /
    temperature``, its noise from ``rng`` (a ``torch.Generator`` on the
    device, or a seed; None is seed 0): the JAX package's distribution,
    not its stream."""
    p, prompt, n_prompt, total = _prep_decode(
        params, prompt_ids, max_new_tokens, max_len, "generate", device)
    dev = p["tok_embed.w"].device
    gen = _generator(rng, dev) if temperature > 0.0 else None
    caches = _new_caches(p, (), n_layers, n_heads, max_len)
    prompt_t = torch.tensor(prompt, device=dev)
    tok = prompt_t[0]
    eos = torch.tensor(eos_id, device=dev)
    done = torch.tensor(False, device=dev)
    out = []
    for t in range(total - 1):
        h, caches = _step_token(p, _embed(p, tok, t), caches, t,
                                n_layers=n_layers, n_heads=n_heads,
                                max_len=max_len)
        if t + 1 < n_prompt:
            # inside the prompt the given token is fed (teacher forcing);
            # the step only fills the caches
            tok = prompt_t[t + 1]
            continue
        logits = _logits(p, h)
        if gen is not None:
            u = torch.rand(logits.shape, generator=gen, device=dev)
            u = u.clamp_min(torch.finfo(torch.float32).tiny)
            nxt = torch.argmax(logits / temperature - torch.log(-torch.log(u)))
        else:
            nxt = torch.argmax(logits)
        tok = torch.where(done, eos, nxt)
        done = done | (tok == eos)
        out.append(tok)
    if not out:
        return np.zeros((0,), np.int32)
    return torch.stack(out).cpu().numpy().astype(np.int32)


def block_apply(p_block, x, *, n_heads: int):
    """Functional full-sequence decoder block: x [..., S, d] -> [..., S,
    d], the layer graph's ``block`` (causal self-attention, pre-LN,
    tanh-GELU FFN) as a pure function of the block-local parameter names
    (``ln1.gamma``, ``attn.wq``, ``ffn_up.w0`` ...); a stack of them is
    the trained model's body, and a pipeline stage's.  Each leading row
    is one sequence; padding after a row's tokens never reaches them.
    The same ops and dtype policy as the layer graph: products through
    ``ops.math.matmul``, attention by ``flash_attention`` (B1-B3 on the
    card, their plain versions on the CPU)."""
    shape = x.shape
    s, d = shape[-2:]
    x = x.reshape(-1, s, d)
    b = x.shape[0]
    dt = pmath.dense_activation_dtype()
    a_in = _ln(x, p_block["ln1.gamma"], p_block["ln1.beta"])
    qkv_t = pmath.compute_dtype(a_in)
    q, k, v = (pmath.matmul(a_in, p_block[f"attn.{w}"]).to(qkv_t).reshape(
        b, s, n_heads, d // n_heads) for w in ("wq", "wk", "wv"))
    o = flash_attention(q, k, v, causal=True)
    x = x + pmath.matmul(o.reshape(b, s, d), p_block["attn.wo"]).to(dt)
    f_in = _ln(x, p_block["ln2.gamma"], p_block["ln2.beta"])
    h = F.gelu((pmath.matmul(f_in, p_block["ffn_up.w0"])
                + p_block["ffn_up.b"]).to(dt), approximate="tanh")
    x = x + (pmath.matmul(h, p_block["ffn_down.w0"])
             + p_block["ffn_down.b"]).to(dt)
    return x.reshape(shape)


def stage_params(params, n_layers: int) -> List[Dict]:
    """Split a trained parameter dict into per-block dicts under the
    block-local names :func:`block_apply` takes."""
    items = list(dict(params).items())
    out = []
    for i in range(n_layers):
        prefix = f"blk{i}_"
        out.append({k[len(prefix):]: v for k, v in items
                    if k.startswith(prefix)})
    return out


def beam_generate(params, prompt_ids, max_new_tokens: int, *, n_layers: int,
                  n_heads: int, beam_size: int = 4, max_len: int = 1024,
                  eos_id: int = -1, length_penalty: float = 0.0,
                  candidate_adjust: Optional[Callable] = None,
                  path_filter: Optional[Callable] = None,
                  stop_condition: Optional[Callable] = None,
                  device: DeviceLike = None):
    """Beam-search decode; returns (tokens [max_new_tokens] int32, score
    float) of the best beam.  Scores are sums of token log-probabilities,
    divided by length ** ``length_penalty`` at the final pick (0: the
    sum, 1: the mean log-probability).

    The hooks are ``generation.beam_search``'s, each shown a
    ``BeamState`` of the prompt's ``beam_size`` beams:
    ``candidate_adjust(logp [K, V], beam)`` returns the adjusted
    continuation log-probabilities of the live beams;
    ``path_filter(beam) -> keep [K]`` drops selected beams (score
    -1e30); ``stop_condition(beam) -> bool`` marks every beam done, so
    the remaining steps extend each with ``eos_id`` at no cost."""
    p, prompt, n_prompt, total = _prep_decode(
        params, prompt_ids, max_new_tokens, max_len, "beam_generate", device)
    if max_new_tokens == 0:
        return np.zeros((0,), np.int32), 0.0
    toks, scores = _beam_run(p, [prompt], total, n_layers, n_heads, max_len,
                             int(beam_size), int(eos_id),
                             float(length_penalty), candidate_adjust,
                             path_filter, stop_condition)
    return toks[0], float(scores[0])


def beam_generate_batch(params, prompts: Sequence, max_new_tokens: int, *,
                        n_layers: int, n_heads: int, beam_size: int = 4,
                        max_len: int = 1024, eos_id: int = -1,
                        length_penalty: float = 0.0,
                        candidate_adjust: Optional[Callable] = None,
                        path_filter: Optional[Callable] = None,
                        stop_condition: Optional[Callable] = None,
                        device: DeviceLike = None):
    """Beam-decode a batch of equal-length prompts together (the model
    step runs over every prompt's beams at once; each hook is called
    prompt by prompt with that prompt's [K] state, as under the JAX
    package's ``vmap``).  Returns (tokens [N, max_new] int32, scores
    [N] f32), each prompt's as :func:`beam_generate` gives it."""
    prompts = [list(pr) for pr in prompts]
    n_prompt = len(prompts[0])
    if not all(len(pr) == n_prompt for pr in prompts):
        raise ValueError("beam_generate_batch needs equal-length prompts "
                         "(bucket them host-side)")
    p, _, n_prompt, total = _prep_decode(
        params, prompts[0], max_new_tokens, max_len, "beam_generate", device)
    if max_new_tokens == 0:
        return (np.zeros((len(prompts), 0), np.int32),
                np.zeros((len(prompts),), np.float32))
    return _beam_run(p, prompts, total, n_layers, n_heads, max_len,
                     int(beam_size), int(eos_id), float(length_penalty),
                     candidate_adjust, path_filter, stop_condition)


def _beam_state(t_rel: int, toks, scores, done, hist, eos_id: int):
    """One prompt's beams as the hooks see them; ``lengths`` counts the
    history's entries that are not ``eos_id`` (the zeros not yet written
    included), as the JAX package counts them."""
    return BeamState(t_rel, toks, scores, done,
                     (hist != eos_id).sum(dim=1).to(torch.int32))


@torch.no_grad()
def _beam_run(p, prompts, total: int, n_layers: int, n_heads: int,
              max_len: int, k: int, eos_id: int, length_penalty: float,
              candidate_adjust, path_filter, stop_condition):
    """Beam search over N prompts of one length: (tokens [N, max_new]
    int32, scores [N] f32) as numpy arrays."""
    dev = p["tok_embed.w"].device
    n, n_prompt = len(prompts), len(prompts[0])
    max_new = total - n_prompt
    prompt = torch.tensor(prompts, dtype=torch.long, device=dev)
    # prefill: one beam a prompt consumes the prompt but its last token
    caches = _new_caches(p, (n,), n_layers, n_heads, max_len)
    for t in range(n_prompt - 1):
        _, caches = _step_token(p, _embed(p, prompt[:, t], t), caches, t,
                                n_layers=n_layers, n_heads=n_heads,
                                max_len=max_len)
    # ... then it is copied to the prompt's k beams
    caches = [tuple(c.repeat_interleave(k, dim=0) for c in kv)
              for kv in caches]
    toks = prompt[:, n_prompt - 1:].expand(n, k)
    # only beam 0 is live at entry (all beams share the prompt)
    scores = torch.full((n, k), NEG, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((n, k), dtype=torch.bool, device=dev)
    hist = torch.zeros((n, k, max_new), dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev)[:, None] * k
    for t in range(n_prompt - 1, total - 1):
        h, caches = _step_token(p, _embed(p, toks.reshape(-1), t), caches,
                                t, n_layers=n_layers, n_heads=n_heads,
                                max_len=max_len)
        logp = torch.log_softmax(_logits(p, h), dim=-1)
        vocab = logp.shape[-1]
        logp = logp.reshape(n, k, vocab)
        t_rel = t - (n_prompt - 1)
        if candidate_adjust is not None:
            logp = torch.stack([candidate_adjust(logp[i], _beam_state(
                t_rel, toks[i], scores[i], done[i], hist[i], eos_id))
                for i in range(n)])
        # done beams extend only with eos at no cost; the live ones add
        # their log-probabilities (after the adjust: hooks cannot
        # unfreeze a beam).  eos_id -1 indexes the last entry, as JAX's
        # .at[-1] does.
        eos_row = torch.full((vocab,), NEG, device=dev)
        eos_row[eos_id] = 0.0
        logp = torch.where(done[..., None], eos_row, logp)
        cand = scores[..., None] + logp
        top_scores, top_idx = _top_k_stable(cand.reshape(n, k * vocab), k)
        top_scores = top_scores.clone()
        parent = top_idx // vocab
        tok_next = top_idx % vocab
        sel = (rows + parent).reshape(-1)
        caches = [(kc[sel], vc[sel]) for kc, vc in caches]
        new_done = torch.gather(done, 1, parent) | (tok_next == eos_id)
        hist = torch.gather(hist, 1, parent[..., None].expand(-1, -1,
                                                              max_new))
        hist[:, :, t_rel] = tok_next
        if path_filter is not None or stop_condition is not None:
            for i in range(n):
                beam_now = _beam_state(t_rel, tok_next[i],
                                       top_scores[i].clone(),
                                       new_done[i].clone(), hist[i], eos_id)
                if path_filter is not None:
                    keep = torch.as_tensor(path_filter(beam_now),
                                           dtype=torch.bool, device=dev)
                    top_scores[i] = torch.where(keep, beam_now.scores, NEG)
                if stop_condition is not None:
                    new_done[i] |= torch.as_tensor(stop_condition(beam_now),
                                                   dtype=torch.bool,
                                                   device=dev)
        toks, scores, done = tok_next, top_scores, new_done
    # length-normalized final pick (done beams ended at eos)
    first_eos = torch.argmax((hist == eos_id).to(torch.int32), dim=2)
    gen_len = torch.where(done, first_eos + 1, max_new)
    norm = torch.pow(gen_len.clamp_min(1).float(), length_penalty)
    best = torch.argmax(scores / norm, dim=1)
    idx = torch.arange(n, device=dev)
    return (hist[idx, best].cpu().numpy().astype(np.int32),
            scores[idx, best].cpu().numpy().astype(np.float32))
