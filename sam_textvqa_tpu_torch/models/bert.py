"""BERT blocks with pytorch_transformers==1.0.0 numerics and module names
(reference sam/sa_m4c.py:374-396): BertEmbeddings / BertLayer / TextBert.
Submodule names produce the reference ``state_dict`` keys.

Dropout sites, as in the JAX package's ``models/bert.py``: the embeddings
after their LayerNorm (:66), the attention probs (:99), and the hidden
states after the self-output and FFN-output products (:119-123, :169-173).
Each forward takes ``generator``; None is the deterministic forward. A
``BertLayer`` also takes ``masks``, its three sites' keep masks drawn before
(``mmt.mmt_dropout_masks``: the dropout variants), which then replace its
own draws."""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Dense, LayerNormTF, dropout, gelu_erf, masked_softmax_attention


class BertEmbeddings(nn.Module):
    """Token + position + type embeddings -> LayerNorm -> dropout."""

    def __init__(self, vocab_size, hidden_size=768, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12, hidden_dropout_prob=0.0):
        super().__init__()
        self.hidden_dropout_prob = hidden_dropout_prob
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.LayerNorm = LayerNormTF(hidden_size, layer_norm_eps)

    def forward(self, input_ids, dtype, generator=None):
        length = input_ids.shape[1]
        x = (
            self.word_embeddings(input_ids.long())
            + self.position_embeddings.weight[None, :length]
            + self.token_type_embeddings.weight[0]
        ).to(dtype)
        return dropout(self.LayerNorm(x), self.hidden_dropout_prob, generator)


def split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, D // H)."""
    b, length, d = t.shape
    return t.view(b, length, h, d // h).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, L, hd) -> (B, L, H * hd)."""
    b, h, length, hd = t.shape
    return t.transpose(1, 2).reshape(b, length, h * hd)


class BertSelfAttention(nn.Module):
    """Multi-head self-attention under an additive (B, 1|H, L, L) bias."""

    def __init__(self, hidden_size=768, num_heads=12, attention_probs_dropout_prob=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.query = Dense(hidden_size, hidden_size)
        self.key = Dense(hidden_size, hidden_size)
        self.value = Dense(hidden_size, hidden_size)

    def qkv(self, x):
        h = self.num_heads
        return (split_heads(self.query(x), h), split_heads(self.key(x), h),
                split_heads(self.value(x), h))

    def forward(self, x, bias, generator=None, keep=None):
        q, k, v = self.qkv(x)
        hd = q.shape[-1]
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = masked_softmax_attention(
            scores, bias, dropout_rate=self.attention_probs_dropout_prob, generator=generator,
            keep=keep)
        return merge_heads(torch.matmul(probs, v))


class BertSelfOutput(nn.Module):
    def __init__(self, hidden_size=768, layer_norm_eps=1e-12, hidden_dropout_prob=0.0):
        super().__init__()
        self.hidden_dropout_prob = hidden_dropout_prob
        self.dense = Dense(hidden_size, hidden_size)
        self.LayerNorm = LayerNormTF(hidden_size, layer_norm_eps)

    def forward(self, hidden, residual, generator=None, keep=None):
        hidden = dropout(self.dense(hidden), self.hidden_dropout_prob, generator, keep)
        return self.LayerNorm(hidden + residual)


class BertAttention(nn.Module):
    def __init__(self, self_attention: nn.Module, hidden_size=768, layer_norm_eps=1e-12,
                 hidden_dropout_prob=0.0):
        super().__init__()
        self.self = self_attention
        self.output = BertSelfOutput(hidden_size, layer_norm_eps, hidden_dropout_prob)


class _Dense(nn.Module):
    """Holder giving the reference's ``intermediate.dense`` key."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.dense = Dense(d_in, d_out)


class BertOutput(nn.Module):
    def __init__(self, intermediate_size, hidden_size=768, layer_norm_eps=1e-12):
        super().__init__()
        self.dense = Dense(intermediate_size, hidden_size)
        self.LayerNorm = LayerNormTF(hidden_size, layer_norm_eps)


class BertLayer(nn.Module):
    """attention -> intermediate (dense + GeLU) -> output (dense + residual +
    LayerNorm). ``attention.self`` may be a spatial attention module."""

    def __init__(self, hidden_size=768, num_heads=12, intermediate_size=3072,
                 layer_norm_eps=1e-12, self_attention: nn.Module = None,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0):
        super().__init__()
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention = BertAttention(
            self_attention if self_attention is not None
            else BertSelfAttention(hidden_size, num_heads, attention_probs_dropout_prob),
            hidden_size, layer_norm_eps, hidden_dropout_prob,
        )
        self.intermediate = _Dense(hidden_size, intermediate_size)
        self.output = BertOutput(intermediate_size, hidden_size, layer_norm_eps)

    def ffn(self, attn_out, generator=None, keep=None):
        inter = gelu_erf(self.intermediate.dense(attn_out))
        out = dropout(self.output.dense(inter), self.hidden_dropout_prob, generator, keep)
        return self.output.LayerNorm(out + attn_out)

    def forward(self, x, *attn_args, generator=None, masks=None, **attn_kwargs):
        """``masks``: {"attn", "self_out", "ffn_out"} keep masks (None where
        the site's rate is 0) drawn for this layer; with them the layer
        draws nothing from ``generator``."""
        masks = masks or {}
        if masks:
            generator = None
        ctx = self.attention.self(x, *attn_args, generator=generator, keep=masks.get("attn"),
                                  **attn_kwargs)
        return self.ffn(self.attention.output(ctx, x, generator, masks.get("self_out")),
                        generator, masks.get("ffn_out"))


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class TextBert(nn.Module):
    """BERT encoder over the question (reference sa_m4c.py:374-396)."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=3,
                 num_heads=12, intermediate_size=3072, layer_norm_eps=1e-12,
                 max_position_embeddings=512, type_vocab_size=2,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0):
        super().__init__()
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, max_position_embeddings, type_vocab_size,
            layer_norm_eps, hidden_dropout_prob,
        )
        self.encoder = _Encoder([
            BertLayer(hidden_size, num_heads, intermediate_size, layer_norm_eps,
                      hidden_dropout_prob=hidden_dropout_prob,
                      attention_probs_dropout_prob=attention_probs_dropout_prob)
            for _ in range(num_hidden_layers)
        ])

    def forward(self, question_indices, question_mask, dtype, generator=None):
        x = self.embeddings(question_indices, dtype, generator)
        # (1 - m) * -10000, broadcast over heads and query positions
        bias = ((1.0 - question_mask.float()) * -10000.0)[:, None, None, :]
        for layer in self.encoder.layer:
            x = layer(x, bias, generator=generator)
        return x
