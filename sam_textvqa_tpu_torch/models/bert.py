"""BERT blocks with pytorch_transformers==1.0.0 numerics and module names
(reference sam/sa_m4c.py:374-396): BertEmbeddings / BertLayer / TextBert.
Submodule names produce the reference ``state_dict`` keys."""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Dense, LayerNormTF, gelu_erf, masked_softmax_attention


class BertEmbeddings(nn.Module):
    """Token + position + type embeddings -> LayerNorm (dropout omitted:
    the port's forward is deterministic)."""

    def __init__(self, vocab_size, hidden_size=768, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.LayerNorm = LayerNormTF(hidden_size, layer_norm_eps)

    def forward(self, input_ids, dtype):
        length = input_ids.shape[1]
        x = (
            self.word_embeddings(input_ids.long())
            + self.position_embeddings.weight[None, :length]
            + self.token_type_embeddings.weight[0]
        ).to(dtype)
        return self.LayerNorm(x)


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

    def __init__(self, hidden_size=768, num_heads=12):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(hidden_size, hidden_size)
        self.key = Dense(hidden_size, hidden_size)
        self.value = Dense(hidden_size, hidden_size)

    def qkv(self, x):
        h = self.num_heads
        return (split_heads(self.query(x), h), split_heads(self.key(x), h),
                split_heads(self.value(x), h))

    def forward(self, x, bias):
        q, k, v = self.qkv(x)
        hd = q.shape[-1]
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = masked_softmax_attention(scores, bias)
        return merge_heads(torch.matmul(probs, v))


class BertSelfOutput(nn.Module):
    def __init__(self, hidden_size=768, layer_norm_eps=1e-12):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size)
        self.LayerNorm = LayerNormTF(hidden_size, layer_norm_eps)

    def forward(self, hidden, residual):
        return self.LayerNorm(self.dense(hidden) + residual)


class BertAttention(nn.Module):
    def __init__(self, self_attention: nn.Module, hidden_size=768, layer_norm_eps=1e-12):
        super().__init__()
        self.self = self_attention
        self.output = BertSelfOutput(hidden_size, layer_norm_eps)


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
                 layer_norm_eps=1e-12, self_attention: nn.Module = None):
        super().__init__()
        self.attention = BertAttention(
            self_attention if self_attention is not None
            else BertSelfAttention(hidden_size, num_heads),
            hidden_size, layer_norm_eps,
        )
        self.intermediate = _Dense(hidden_size, intermediate_size)
        self.output = BertOutput(intermediate_size, hidden_size, layer_norm_eps)

    def ffn(self, attn_out):
        inter = gelu_erf(self.intermediate.dense(attn_out))
        return self.output.LayerNorm(self.output.dense(inter) + attn_out)

    def forward(self, x, *attn_args, **attn_kwargs):
        ctx = self.attention.self(x, *attn_args, **attn_kwargs)
        return self.ffn(self.attention.output(ctx, x))


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class TextBert(nn.Module):
    """BERT encoder over the question (reference sa_m4c.py:374-396)."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=3,
                 num_heads=12, intermediate_size=3072, layer_norm_eps=1e-12,
                 max_position_embeddings=512, type_vocab_size=2):
        super().__init__()
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, max_position_embeddings, type_vocab_size,
            layer_norm_eps,
        )
        self.encoder = _Encoder([
            BertLayer(hidden_size, num_heads, intermediate_size, layer_norm_eps)
            for _ in range(num_hidden_layers)
        ])

    def forward(self, question_indices, question_mask, dtype):
        x = self.embeddings(question_indices, dtype)
        # (1 - m) * -10000, broadcast over heads and query positions
        bias = ((1.0 - question_mask.float()) * -10000.0)[:, None, None, :]
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
