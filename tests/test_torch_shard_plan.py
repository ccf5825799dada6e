"""The work partition of the decode step's one-launch shard entries, on the
CPU (no JAX, no card).

``csrc/decode_step.cu`` plans each launch on the host (``ffn_plan``,
``attention_plan``): a cluster size S, heads per cluster, groups of batch
rows, the n8 tiles of a group and the shared-memory layout. This file
mirrors that planning in Python (:func:`plan`) and holds it to what the
kernels rely on, for c3's tp 2 and tp 4 shard widths, heads of 64 and 32,
f32 and bf16, and batches of 1 to 96:

* every CTA's shared memory fits the H100's 227 KB;
* every batch row lies in one group, every FF1 column in one CTA, every
  FF2 output row and every Wout row in one rank of a cluster, every head in
  one head block, every q/k/v row of a block in one CTA, every (row, head)
  pair at one owner; a cluster's FF2 K-slice is exactly its CTAs' FF1
  columns;
* summing the clusters' f32 partial tiles in cluster order, as the last CTA
  to arrive does, gives the plain versions' products (f32, 1e-5).
"""

import numpy as np
import pytest
import torch

from sam_textvqa_tpu_torch.models.layers import gelu_erf
from sam_textvqa_tpu_torch.ops.decode_attention import decode_attention_plain
from sam_textvqa_tpu_torch.ops.decode_step import (decode_shard_attention_plain,
                                                   decode_shard_ffn_plain)

MAX_SMEM = 232448  # bytes of shared memory a CTA may use on an H100
THREADS, WARPS, HEADER = 256, 8, 64
TARGET_CTAS = 132


def slice_stride(nbytes: int) -> int:
    return nbytes + (64 if nbytes % 128 == 0 else 0)


def align16(n: int) -> int:
    return (n + 15) // 16 * 16


def ffn_smem(d, s, nt, esize):
    xs, hs = slice_stride(d * esize), slice_stride(16 * s * esize)
    return align16(HEADER + 16 * d * esize + d // s * hs + 8 * nt * xs + 8 * nt * hs
                   + WARPS * 128 * nt * 4 + 8 * nt * 16 * esize) + 16 * 16


def attention_smem(d, hd, hc, s, le, t_max, nt, mode, esize):
    """Bytes of a CTA's shared memory under K/V buffer ``mode``: 0 two
    buffers of their own, 1 one of its own and one over Wqkv's tiles, 2 one
    over Wqkv's tiles."""
    width = hc * hd
    rq = 3 * width // s
    xs, os_ = slice_stride(d * esize), slice_stride(width * esize)
    kv_rows = le + t_max
    buf = 2 * kv_rows * hd * esize
    wq = rq * d * esize
    at = HEADER + (max(wq, buf) if mode else wq) + d // s * os_ + 8 * nt * xs
    at += 8 * nt * os_ + (8 * nt + s - 1) // s * 3 * width * 4 + 8 * nt * rq * 4
    at += max(WARPS, rq // 16) * 128 * nt * 4
    end = align16(align16(align16(at + 2 * (hd + kv_rows + WARPS * hd) * 4) + 2 * hd * esize)
                  + rq * esize)
    return end + (2 - mode) * buf


def _groups(b, per, capacity, nt_max):
    groups = max(-(-b // (8 * nt_max)), min(b, max(1, capacity // per)))
    group = -(-b // groups)
    groups = -(-b // group)
    return groups, group, -(-group // 8)


def plan(part, b, d, w, esize, hd=64, le=170, t_max=12, capacity=lambda s: TARGET_CTAS // s):
    """The C planner's choice for one launch (part ``attention`` or
    ``ffn``); ``capacity(S)``: the clusters of S CTAs that fit on the card
    at once (the occupancy query; 0: none fits)."""
    if b < 1 or d % 64 or w % 64:
        return None
    if part == "ffn":
        for s in range(16, 0, -1):
            if (w // 16) % s or (d // 16) % s or 16 * s * esize % 64:
                continue
            nts = [nt for nt in range(1, 5) if ffn_smem(d, s, nt, esize) <= MAX_SMEM]
            per = w // 16 // s
            if not nts or (s > 8 and capacity(s) < per):
                continue
            groups, group, nt = _groups(b, per, capacity(s) or TARGET_CTAS // s, max(nts))
            return dict(S=s, hc=1, clusters=per, groups=groups, group=group, nt=nt, bufs=1,
                        alias=False, smem=ffn_smem(d, s, nt, esize), counters=groups * s,
                        partial_bytes=4 * groups * per * d * 8 * nt)
        return None
    if w % hd or hd * esize % 16 or hd * esize > 512:
        return None
    hc = next(h for h in (1, 2, 4, 8) if 3 * hd * h % 16 == 0 and hd * h * esize % 64 == 0
              and (w // hd) % h == 0)
    best, best_key = None, None
    for s in range(8, 0, -1):
        if (3 * hd * hc // 16) % s or (d // 16) % s:
            continue
        fits = {}
        for nt in range(1, 5):
            mode = next((m for m in range(3) if attention_smem(d, hd, hc, s, le, t_max, nt, m,
                                                               esize) <= MAX_SMEM), None)
            if mode is not None:
                fits[nt] = mode
        if not fits:
            continue
        per = w // hd // hc
        groups, group, nt = _groups(b, per, capacity(s), max(fits))
        mode = fits[nt]
        width = hc * hd
        # bytes a CTA takes in: Wqkv and Wout slices, the group's x, its rows' K/V
        nbytes = esize * (3 * width * d // s + d // s * width + group * d
                          + -(-group // s) * hc * 2 * (le + t_max) * hd)
        ctas = min(groups, max(1, capacity(s) // per)) * per * s
        key = (nbytes, -ctas)
        if best_key is None or key < best_key:
            best_key = key
            best = dict(S=s, hc=hc, clusters=per, groups=groups, group=group, nt=nt,
                        bufs=2 if mode < 2 else 1, mode=mode,
                        smem=attention_smem(d, hd, hc, s, le, t_max, nt, mode, esize),
                        counters=groups * s, partial_bytes=4 * groups * per * d * 8 * nt)
    return best


D, F = 768, 3072
CONFIGS = [(tp, hd, esize, b) for tp in (2, 4) for hd in (64, 32) for esize in (4, 2)
           for b in (1, 3, 5, 8, 32, 33, 96)]


@pytest.mark.parametrize("tp,hd,esize,b", CONFIGS)
def test_plans_fit_and_cover(tp, hd, esize, b):
    # clusters that fit at once: by SMs alone, by 16- and 18-SM GPCs, and
    # with no room for clusters above the portable 8
    for capacity in (lambda s: TARGET_CTAS // s, lambda s: 8 * (16 // s),
                     lambda s: 7 * (18 // s), lambda s: 0 if s > 8 else TARGET_CTAS // s):
        att = plan("attention", b, D, D // tp, esize, hd=hd, capacity=capacity)
        ffn = plan("ffn", b, D, F // tp, esize, capacity=capacity)
        for p in (att, ffn):
            assert p is not None and p["smem"] <= MAX_SMEM, p
            assert p["group"] <= 8 * p["nt"] <= 32
            rows = [r for g in range(p["groups"])
                    for r in range(g * p["group"], min(b, (g + 1) * p["group"]))]
            assert rows == list(range(b))  # every row in one group, no group empty
            assert (b - 1) // p["group"] == p["groups"] - 1
        # FFN: CTA c (cluster c // S, rank c % S) computes h columns 16 c..;
        # its cluster's FF2 K-slice is the cluster's columns; rank r owns FF2
        # output rows r D / S..
        s, w = ffn["S"], F // tp
        cols = [16 * c + j for c in range(w // 16) for j in range(16)]
        assert cols == list(range(w))
        for blk in range(ffn["clusters"]):
            mine = {16 * (blk * s + r) + j for r in range(s) for j in range(16)}
            assert mine == set(range(16 * s * blk, 16 * s * (blk + 1)))
        assert sorted(r * (D // s) + i for r in range(s) for i in range(D // s)) == list(range(D))
        assert (16 * s * esize) % 64 == 0 and (D // s) % 16 == 0
        # attention: head blocks of hc heads; CTA r of a block computes the
        # block's virtual q/k/v rows r rq..; row i of a group is owned by
        # rank i % S; rank r multiplies Wout rows r D / S..
        s, hc, width = att["S"], att["hc"], att["hc"] * hd
        rq = 3 * width // s
        assert rq % 16 == 0 and (width * esize) % 64 == 0 and (D // s) % 16 == 0
        heads = D // tp // hd
        assert att["clusters"] * hc == heads
        virtual = sorted(r * rq + i for r in range(s) for i in range(rq))
        assert virtual == list(range(3 * width))
        for g in range(att["groups"]):
            n = min(att["group"], b - g * att["group"])
            owners = [[i for i in range(n) if i % s == r] for r in range(s)]
            assert sorted(i for o in owners for i in o) == list(range(n))
        # one arrival counter per (group, rank)
        for p in (att, ffn):
            assert p["counters"] == p["groups"] * p["S"]


def _ffn_by_clusters(x, w1, b1, w2, p):
    """The FFN kernel's arithmetic in f32 on the CPU: each CTA's 16 GeLU
    columns, each cluster's FF2 over its columns, the clusters' partial
    tiles summed in cluster order."""
    s, d = p["S"], x.shape[1]
    out = torch.empty(x.shape[0], d)
    for g in range(p["groups"]):
        rows = slice(g * p["group"], min(x.shape[0], (g + 1) * p["group"]))
        total = None
        for blk in range(p["clusters"]):
            h = []
            for r in range(s):
                c0 = 16 * (blk * s + r)
                h.append(gelu_erf(x[rows] @ w1[c0:c0 + 16].t() + b1[c0:c0 + 16]))
            h = torch.cat(h, dim=1)
            k0 = 16 * s * blk
            part = torch.cat([h @ w2[r * d // s:(r + 1) * d // s, k0:k0 + 16 * s].t()
                              for r in range(s)], dim=1)
            total = part if total is None else total + part
        out[rows] = total
    return out


@pytest.mark.parametrize("tp,b", [(2, 5), (4, 3), (2, 33)])
def test_ffn_partition_reproduces_plain(tp, b):
    rng = np.random.RandomState(tp + b)
    w = F // tp
    x = torch.from_numpy(rng.randn(b, D).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(1, w, D) / np.sqrt(D)).astype(np.float32))
    b1 = torch.from_numpy(rng.randn(1, w).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(1, D, w) / np.sqrt(w)).astype(np.float32))
    mine = _ffn_by_clusters(x, w1[0], b1[0], w2[0], plan("ffn", b, D, w, 4))
    ref = decode_shard_ffn_plain(x, w1, b1, w2, layer=0)
    assert (mine - ref).abs().max().item() < 1e-5


@pytest.mark.parametrize("tp,hd,b", [(2, 64, 5), (4, 64, 3), (2, 32, 4)])
def test_attention_partition_reproduces_plain(tp, hd, b):
    """q/k/v gathered through the virtual rows of each head block, the
    context per head, the out-projection per rank and head block, the
    blocks' partials summed in block order: the plain version's product and
    K/V row t (f32)."""
    rng = np.random.RandomState(tp + hd + b)
    w, le, t_max, q_len, n_obj, step = D // tp, 30, 4, 6, 14, 2
    p = plan("attention", b, D, w, 4, hd=hd, le=le, t_max=t_max)
    s, hc = p["S"], p["hc"]
    width = hc * hd
    rq = 3 * width // s

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))

    x, wqkv, bqkv = rand(b, D), rand(1, 3 * w, D, scale=D ** -0.5), rand(1, 3 * w)
    wout = rand(1, D, w, scale=w ** -0.5)
    k_enc, v_enc, k_dec, v_dec = (rand(1, b, n, w) for n in (le, le, t_max, t_max))
    seg = torch.from_numpy(np.stack([rng.randint(1, q_len + 1, b), rng.randint(0, n_obj + 1, b),
                                     rng.randint(0, le - q_len - n_obj + 1, b)],
                                    axis=1).astype(np.int32))
    t = torch.tensor([step], dtype=torch.int32)
    kd, vd = k_dec.clone(), v_dec.clone()
    ref = decode_shard_attention_plain(t, seg, x, wqkv, bqkv, wout, k_enc, v_enc, k_dec, v_dec,
                                       layer=0, hd=hd, q_len=q_len, n_obj=n_obj)
    q = torch.empty(b, w)
    total = None
    for hb in range(w // width):
        qkv = torch.empty(b, 3 * width)
        for r in range(s):  # CTA r's virtual rows of the block
            for v in range(r * rq, (r + 1) * rq):
                sec, within = divmod(v, width)
                row = sec * w + hb * width + within
                qkv[:, v] = x @ wqkv[0, row] + bqkv[0, row]
        cols = slice(hb * width, (hb + 1) * width)
        q[:, cols] = qkv[:, :width]
        kd[0, :, step, cols], vd[0, :, step, cols] = qkv[:, width:2 * width], qkv[:, 2 * width:]
        ctx = decode_attention_plain(q[:, cols].contiguous(), k_enc[0, :, :, cols].contiguous(),
                                     v_enc[0, :, :, cols].contiguous(),
                                     kd[0, :, :, cols].contiguous(),
                                     vd[0, :, :, cols].contiguous(), seg, t, hd=hd,
                                     q_len=q_len, n_obj=n_obj)
        part = torch.cat([ctx @ wout[0, r * D // s:(r + 1) * D // s, cols].t()
                          for r in range(s)], dim=1)
        total = part if total is None else total + part
    assert (total - ref).abs().max().item() < 1e-5
    assert torch.allclose(kd, k_dec, atol=1e-5) and torch.allclose(vd, v_dec, atol=1e-5)
