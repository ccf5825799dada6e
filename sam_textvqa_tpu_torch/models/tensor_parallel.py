"""SA-M4C in Megatron tensor parallelism over a list of devices, in one
process: the JAX package's model under a ``model`` mesh axis
(``parallel/mesh.py:shard_params``, ``train.py`` / ``serve.py
--model_parallel``).

:class:`TPSAM4C` cuts a ``SAM4C`` into ``tp`` shards, one per device (a
device may repeat). Each shard is the port's own ``SAM4C`` modules narrowed
by :func:`..parallel.tensor.shard_state_dict`: its attention modules hold
H/tp heads (``num_heads``) and its FFNs intermediate/tp columns. The
residual stream lives on the first device ("home"): each layer copies its
input to the shards, each shard attends over its own heads (the spatial
layers with the relation x head LUT columns of those heads, through the
spatial-attention kernel in the encoder-cache pass; an implicit layer's
shard with its heads' slice of the (spatial + implicit)-head permission
and quadrant cuts, on the plain path), and the two
row-parallel products of the layer are summed on home, where the
replicated biases and LayerNorms apply once. A replicated weight exists
once, on home: every shard's module holds that one ``Parameter``, so its
gradient collects there and an optimizer step leaves no stale copy.

The word embeddings, the classifier and the OCR pointer's query and key
are cut where :func:`..parallel.mesh.shard_axis` cuts them and used whole
otherwise. The classifier's rows are also the decoder's answer embeddings:
each row is looked up on the shard that holds it.

:meth:`TPSAM4C.forward` is ``SAM4C.forward``, dropout included: every mask
is drawn at its full shape on home, in the one-device model's order, from
the step's generator, and each shard takes its heads' slice of the
attention-probs masks, so a train step equals the one-device step (JAX
draws the global array's masks too). :func:`decode_tensor_parallel` is
``fast_decode.greedy_decode_fast``'s path for this model and
:func:`beam_tensor_parallel` ``fast_decode.beam_search_decode_fast``'s;
:meth:`TPSAM4C.decode_step` is ``SAM4C.decode_step`` (the slow beam path's
full recompute).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..config import MATRIX_TYPE_MAP
from ..ops.decode_step import WEIGHT_NAMES
from ..ops.fused_attention import combined_permission
from ..parallel.mesh import check_tensor_parallel
from ..parallel.tensor import (ShardState, broadcast, column_parallel, reduce_sum,
                               row_parallel, shard_state_dict, unshard_state_dict,
                               vocab_parallel_embedding, vocab_parallel_logits)
from .bert import BertSelfAttention, merge_heads, split_heads
from .fast_decode import (KERNEL_STEP_BACKENDS, MMTCache, _beam_context, _cache_attention,
                          _dec_col_bias, _dec_row_embedding, _dec_rows_masked,
                          _decode_one_row_fused, _device_lut, _greedy_steps, _mega_step_consts,
                          _one_row_context, _row_kv, _seg_lens, reorder_beams)
from .layers import (MASK_BIAS, apply_keep_mask, dropout, dropout_generator, gelu_erf,
                     keep_mask, layer_norm_tf, masked_softmax_attention)
from .mmt import implicit_split, layer_heads, mmt_dropout_masks
from .sa_m4c import SAM4C
from .spatial import SpatialBertSelfAttention

#: the stacked decode weights of a shard after the first: its own slices
#: (``_decode_one_row_fused`` reads the replicated ones from the first)
SHARD_CONSTS = ("wqkv", "bqkv", "wout", "wff1", "bff1", "wff2")


def _build_shard(model: SAM4C, state: ShardState, device: torch.device,
                 shared: Optional[Dict[str, nn.Parameter]] = None) -> SAM4C:
    """A ``SAM4C`` holding ``state`` (copied to ``device``), its attention
    modules narrowed to their share of the heads; the keys of ``shared``
    take those parameters themselves instead of a copy."""
    shared = shared or {}
    with torch.device("meta"):
        shard = SAM4C(model.params_cfg, dtype=model.dtype,
                      attention_backend=model.mmt.attention_backend)
    for key, value in state.items():
        owner, _, leaf = key.rpartition(".")
        param = shared.get(key)
        if param is None:
            param = nn.Parameter(value.detach().to(device).clone(
                memory_format=torch.contiguous_format))
        setattr(shard.get_submodule(owner), leaf, param)
    for module in shard.modules():
        if isinstance(module, (BertSelfAttention, SpatialBertSelfAttention)):
            module.num_heads //= state.tp
    left = [n for n, t in (*shard.named_parameters(), *shard.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"the shard state has no value for {left}")
    return shard


def _identity(x):
    return x


def _attend(attention, x, bias, zero_fully_masked: bool, drop):
    """``attention``'s heads over ``x`` under the additive ``bias`` (the
    plain path of ``BertSelfAttention`` and ``SpatialBertSelfAttention``),
    the attention probs passed through ``drop``; the merged context."""
    h = attention.num_heads
    q, k, v = (split_heads(f(x), h) for f in (attention.query, attention.key, attention.value))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = drop(masked_softmax_attention(scores, bias, zero_fully_masked))
    return merge_heads(torch.matmul(probs, v))


class TPSAM4C:
    """``model``'s weights cut over ``devices``, one shard each (see the
    module docstring). The shards hold copies: ``model`` is not changed and
    later changes to it do not reach them."""

    def __init__(self, model: SAM4C, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.tp = len(self.devices)
        check_tensor_parallel(model.params_cfg, self.tp)
        self.params_cfg = model.params_cfg
        sd = model.state_dict()
        states = [shard_state_dict(sd, self.tp, r) for r in range(self.tp)]
        self.axes = states[0].axes
        self.shards: List[SAM4C] = []
        for state, device in zip(states, self.devices):
            shared = {k: self.shards[0].get_parameter(k) for k, axis in self.axes.items()
                      if axis is None} if self.shards else None
            self.shards.append(_build_shard(model, state, device, shared))
        #: key -> the tensor on each shard where it is cut, else the one on home
        self.parts: Dict[str, List[nn.Parameter]] = {
            k: [s.get_parameter(k) for s in (self.shards if axis is not None else self.shards[:1])]
            for k, axis in self.axes.items()}

    @property
    def home(self) -> torch.device:
        """The first device: inputs, the residual stream and the outputs."""
        return self.devices[0]

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (parameters stay float32)."""
        return self.shards[0].dtype

    @dtype.setter
    def dtype(self, value: torch.dtype) -> None:
        for shard in self.shards:
            shard.dtype = value

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The full model's ``state_dict``, put together from the shards."""
        return unshard_state_dict([ShardState(s.state_dict(), tp=self.tp, rank=r, axes=self.axes)
                                   for r, s in enumerate(self.shards)])

    @torch.no_grad()
    def load_state_dict(self, sd, strict: bool = True) -> None:
        """Copy a full model's ``state_dict`` into the shards (each cut
        along its axis, as :func:`..parallel.tensor.shard_state_dict` cuts
        it); ``strict``: the keys must be the model's."""
        missing = [k for k in self.parts if k not in sd]
        unexpected = [k for k in sd if k not in self.parts]
        if strict and (missing or unexpected):
            raise RuntimeError(f"state_dict keys differ: missing {missing}, "
                               f"unexpected {unexpected}")
        for key, parts in self.parts.items():
            if key not in sd:
                continue
            axis = self.axes[key]
            pieces = [sd[key]] if axis is None else sd[key].chunk(self.tp, dim=axis)
            for param, piece in zip(parts, pieces):
                if param.shape != piece.shape:
                    raise RuntimeError(f"{key}: {tuple(piece.shape)} does not fit "
                                       f"{tuple(param.shape)}")
                param.copy_(piece)

    def with_widths(self, n_obj: Optional[int] = None, n_ocr: Optional[int] = None):
        """The same shards at narrower obj/OCR slot counts
        (``models.sa_m4c.with_widths``): every width is read from
        ``params_cfg.mmt``."""
        repl = {k: int(v) for k, v in (("max_obj_num", n_obj), ("max_ocr_num", n_ocr))
                if v is not None}
        if not repl:
            return self
        small = copy.copy(self)
        small.params_cfg = self.params_cfg._replace(
            mmt=dataclasses.replace(self.params_cfg.mmt, **repl))
        return small

    @torch.no_grad()
    def decode_consts(self) -> List[Dict[str, torch.Tensor]]:
        """Each shard's stacked weights for the ``fused`` and ``mega``
        decodes: all of them on home, a later shard its own slices
        (:data:`SHARD_CONSTS`)."""
        return [_mega_step_consts(s.mmt, self.dtype, WEIGHT_NAMES if r == 0 else SHARD_CONSTS)
                for r, s in enumerate(self.shards)]

    # ----- layers -----

    def _probs_dropout(self, layer, x, generator, keep=None) -> list:
        """One function per shard for the attention probs of ``layer`` (home's
        narrowed layer) over ``x``: the one-device model's dropout, its mask
        drawn at the full (B, H, L, L) shape on home (or ``keep``, drawn
        before by a dropout variant) and each shard given its heads' slice;
        the identity without dropout."""
        rate = layer.attention.self.attention_probs_dropout_prob
        if (generator is None and keep is None) or rate == 0.0:
            return [_identity] * self.tp
        b, length = x.shape[:2]
        h = layer.attention.self.num_heads
        if keep is None:
            keep = keep_mask((b, h * self.tp, length, length), rate, generator, x.device)
        return [functools.partial(apply_keep_mask, keep=keep[:, r * h:(r + 1) * h].to(dev),
                                  rate=rate) for r, dev in enumerate(self.devices)]

    def _layer(self, layers, x, attend, generator=None, masks=None):
        """One BERT layer over ``x`` (on home): ``layers`` are the shards'
        narrowed layers and ``attend(r, layer, x_r, drop)`` shard r's merged
        attention context, its probs passed through ``drop``. The hidden
        dropouts apply on home to the summed products, before the residual
        adds, as in ``bert.BertSelfOutput`` and ``BertLayer.ffn``. ``masks``:
        the layer's keep masks of a dropout variant
        (``mmt.mmt_dropout_masks``, one-device shapes), used instead of
        draws from ``generator``."""
        home = layers[0]
        if masks is not None:
            generator = None
        masks = masks or {}
        drops = self._probs_dropout(home, x, generator, masks.get("attn"))
        xs = broadcast(x, self.devices)
        ctxs = [attend(r, layer, xs[r], drops[r]) for r, layer in enumerate(layers)]
        y = row_parallel(ctxs, [l.attention.output.dense.weight for l in layers],
                         home.attention.output.dense.bias, x.device)
        y = dropout(y, home.attention.output.hidden_dropout_prob, generator,
                    masks.get("self_out"))
        attn_out = home.attention.output.LayerNorm(y + x)
        inters = [gelu_erf(h) for h in column_parallel(
            attn_out, [l.intermediate.dense.weight for l in layers],
            [l.intermediate.dense.bias for l in layers])]
        y = row_parallel(inters, [l.output.dense.weight for l in layers],
                         home.output.dense.bias, x.device)
        y = dropout(y, home.hidden_dropout_prob, generator, masks.get("ffn_out"))
        return home.output.LayerNorm(y + attn_out)

    def _mmt_layers(self):
        """(layer_type, mix, the shards' layers) in ``layer_type_list`` order."""
        for layers in zip(*(s.mmt.iter_layers() for s in self.shards)):
            yield layers[0][0], layers[0][1], [layer for _, _, layer in layers]

    def _text_bert(self, ids, mask, generator=None):
        emb = self.shards[0].text_bert.embeddings
        words = vocab_parallel_embedding(
            ids.long(), self.parts["text_bert.embeddings.word_embeddings.weight"], ids.device)
        x = (words + emb.position_embeddings.weight[None, :ids.shape[1]]
             + emb.token_type_embeddings.weight[0]).to(self.dtype)
        x = dropout(emb.LayerNorm(x), emb.hidden_dropout_prob, generator)
        biases = broadcast(((1.0 - mask.float()) * MASK_BIAS)[:, None, None, :], self.devices)
        for layers in zip(*(s.text_bert.encoder.layer for s in self.shards)):
            x = self._layer(layers, x, lambda r, m, xr, drop: _attend(
                m.attention.self, xr, biases[r], False, drop), generator)
        return x

    def encode(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``SAM4C.encode`` on home; dropout draws from ``generator`` (None:
        none)."""
        home = self.shards[0]
        obj_mmt_in, ocr_mmt_in = home.encode_regions(batch, generator)
        text = self._text_bert(batch["question_indices"], batch["question_mask"], generator)
        if home.text_bert_out_linear is not None:
            text = home.text_bert_out_linear(text)
        return {"text_bert_emb": text, "obj_mmt_in": obj_mmt_in, "ocr_mmt_in": ocr_mmt_in}

    # ----- output head -----

    def answer_tables(self, dtype) -> List[torch.Tensor]:
        """The layernormed answer embeddings (the classifier's rows in
        ``dtype``), each part on the shard that holds its rows; the
        LayerNorm is home's."""
        ln = self.shards[0].mmt.prev_pred_embeddings.ans_layer_norm
        return [layer_norm_tf(w.to(dtype), ln.weight.to(w.device), ln.bias.to(w.device), ln.eps)
                for w in self.parts["classifier.weight"]]

    @property
    def num_answers(self) -> int:
        return sum(w.shape[0] for w in self.parts["classifier.weight"])

    def classify(self, x):
        """The classifier's logits of ``x`` in vocab order, on ``x``'s device."""
        return vocab_parallel_logits(x, self.parts["classifier.weight"],
                                     self.parts["classifier.bias"], x.device)

    def ptr_project(self, x, which: str) -> List[torch.Tensor]:
        """The OCR pointer's ``query`` or ``key`` projection of ``x``, one
        part per shard that holds a slice of it."""
        return column_parallel(x, self.parts[f"ocr_ptr_net.{which}.weight"],
                               self.parts[f"ocr_ptr_net.{which}.bias"])

    def ptr_norm(self) -> float:
        """The pointer scores' divisor: the root of the whole query width."""
        return math.sqrt(self.shards[0].ocr_ptr_net.query_key_size)

    # ----- teacher-forced forward -----

    def _prev_pred_embeddings(self, ocr_emb, prev_inds, generator=None):
        """``mmt.PrevPredEmbeddings``."""
        pp = self.shards[0].mmt.prev_pred_embeddings
        dtype = ocr_emb.dtype
        ans_num = self.num_answers
        ocr_emb = pp.ocr_layer_norm(ocr_emb)
        prev = prev_inds.long()
        is_vocab = prev < ans_num
        from_vocab = vocab_parallel_embedding(torch.where(is_vocab, prev, 0),
                                              self.answer_tables(dtype), prev.device)
        ocr_idx = torch.where(is_vocab, 0, prev - ans_num)
        from_ocr = torch.gather(ocr_emb, 1, ocr_idx[:, :, None].expand(-1, -1, ocr_emb.shape[-1]))
        raw = torch.where(is_vocab[:, :, None], from_vocab, from_ocr)
        token_type = (prev >= ans_num).long()
        emb = (pp.position_embeddings.weight[None, :prev.shape[1]]
               + pp.token_type_embeddings.weight[token_type]).to(dtype)
        return raw + dropout(pp.emb_layer_norm(emb), pp.hidden_dropout_prob, generator)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``SAM4C.forward``, teacher-forced on ``train_prev_inds``: the MMT
        outputs, ``scores`` and with ``use_aux_heads`` ``spatial_head_out``,
        on home. With ``deterministic=False`` every
        dropout site draws from ``generator`` (on home) the one-device
        model's masks; the spatial layers then take the plain attention, as
        ``SAM4C`` does (the kernel has no backward)."""
        g = dropout_generator(deterministic, generator, self.shards[0]._dropout_rates())
        out = self.decode_step(self.encode(batch, g), batch, batch["train_prev_inds"],
                               deterministic, g)
        if self.params_cfg.mmt.use_aux_heads:  # replicated weights: home's modules
            out["spatial_head_out"] = self.shards[0].aux_head(out["mmt_seq_output"])
        return out

    def decode_step(self, encodings, batch: Dict[str, torch.Tensor], prev_inds,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``SAM4C.decode_step``: one MMT and output-heads pass over
        ``encodings`` (:meth:`encode`'s) for the previous predictions
        ``prev_inds``, on home; the MMT outputs and ``scores``. Dropout as
        in :meth:`forward`."""
        cfg = self.params_cfg.mmt
        home = self.shards[0]
        g = dropout_generator(deterministic, generator, home._dropout_rates())
        dec_emb = self._prev_pred_embeddings(encodings["ocr_mmt_in"], prev_inds, g)
        x = torch.cat([encodings["text_bert_emb"], encodings["obj_mmt_in"],
                       encodings["ocr_mmt_in"], dec_emb], 1)
        b, dec_len = x.shape[0], dec_emb.shape[1]
        classes = batch["spatial_classes"]
        q_len = cfg.max_seq_length
        col_mask = torch.cat([batch["question_mask"].float(), batch["pad_obj_mask"].float(),
                              batch["pad_ocr_mask"].float(),
                              torch.zeros(b, dec_len, device=x.device)], dim=1)
        perm = dict(q_len=q_len, n_ctx=classes.shape[-1], dec_len=dec_len,
                    mask_quadrants=tuple(cfg.attention_mask_quadrants))
        base_ok = combined_permission(classes, None, col_mask, spatial=False, num_heads=1, **perm)
        base = broadcast(torch.where(base_ok, 0.0, MASK_BIAS), self.devices)
        masks, classes_r = broadcast(col_mask, self.devices), broadcast(classes, self.devices)
        spatial_args: List[Dict[tuple, dict]] = [{} for _ in self.devices]
        kernel = deterministic and home.mmt.attention_backend == "kernel"

        def spatial(r, key, layer_type, h):
            if (key, layer_type) not in spatial_args[r]:
                n_sp, n_imp = implicit_split(cfg, layer_type, r * h, h)
                lut = _device_lut(key, r * h, n_sp, self.devices[r])
                # implicit layers take the plain path, as on one device
                if kernel and layer_type == "s":
                    args = {"kernel_ctx": dict(
                        classes=classes_r[r].contiguous(), lut=lut, col_mask=masks[r],
                        spatial=True, **perm)}
                else:
                    args = {"bias": torch.where(combined_permission(
                        classes_r[r], lut, masks[r], spatial=True, num_heads=h,
                        num_implicit_heads=n_imp, **perm), 0.0, MASK_BIAS)}
                spatial_args[r][key, layer_type] = args
            return spatial_args[r][key, layer_type]

        def attend_spatial(key, layer_type):
            def attend(r, m, xr, drop):
                args = spatial(r, key, layer_type, m.attention.self.num_heads)
                if "kernel_ctx" in args:
                    return m.attention.self(xr, kernel_ctx=args["kernel_ctx"])
                return _attend(m.attention.self, xr, args["bias"], True, drop)
            return attend

        drawn = mmt_dropout_masks(cfg, b, x.shape[1], g, x.device)
        for li, (layer_type, mix, layers) in enumerate(self._mmt_layers()):
            drops = None if drawn is None else drawn[li]
            if layer_type == "n":
                x = self._layer(layers, x, lambda r, m, xr, drop: _attend(
                    m.attention.self, xr, base[r], False, drop), g, drops)
            else:
                x = self._layer(layers, x, attend_spatial(MATRIX_TYPE_MAP[mix], layer_type), g,
                                drops)

        ocr_begin = q_len + cfg.max_obj_num
        dec_out = x[:, -dec_len:]
        ocr_out = x[:, ocr_begin:ocr_begin + cfg.max_ocr_num]
        dyn = reduce_sum([torch.matmul(q, k.transpose(-1, -2)) for q, k in zip(
            self.ptr_project(dec_out, "query"), self.ptr_project(ocr_out, "key"))],
            x.device) / self.ptr_norm()
        ocr_bias = ((1.0 - batch["pad_ocr_mask"].to(self.dtype)) * MASK_BIAS)[:, None, :]
        return {
            "mmt_seq_output": x,
            "mmt_txt_output": x[:, :q_len],
            "mmt_ocr_output": ocr_out,
            "mmt_dec_output": dec_out,
            "scores": torch.cat([self.classify(dec_out), dyn + ocr_bias.to(dyn.dtype)], dim=-1),
        }

    # ----- encoder cache -----

    def build_mmt_cache(self, enc, batch, attention_backend: str = "plain") -> List[MMTCache]:
        """``fast_decode.build_mmt_cache`` on the shards: one ``MMTCache``
        per shard, its K/V (L, B, Le, D/tp) of its own heads on its device
        (``enc_out`` and ``ocr_mmt_in`` are home's, shared)."""
        cfg = self.params_cfg.mmt
        x = torch.cat([enc["text_bert_emb"], enc["obj_mmt_in"], enc["ocr_mmt_in"]], dim=1)
        b, le, d = x.shape
        col_mask = torch.cat([batch["question_mask"], batch["pad_obj_mask"],
                              batch["pad_ocr_mask"]], dim=1).float()
        masks = broadcast(col_mask, self.devices)
        biases = broadcast(((1.0 - col_mask) * MASK_BIAS)[:, None, None, :], self.devices)
        classes = broadcast(batch["spatial_classes"], self.devices)
        n_layers = len(cfg.layer_type_list)
        k_all = [x.new_empty(n_layers, b, le, d // self.tp, device=dev) for dev in self.devices]
        v_all = [x.new_empty(n_layers, b, le, d // self.tp, device=dev) for dev in self.devices]
        spatial_bias: List[Dict[tuple, torch.Tensor]] = [{} for _ in self.devices]
        for li, (layer_type, mix, layers) in enumerate(self._mmt_layers()):
            key = MATRIX_TYPE_MAP[mix]
            x = self._layer(layers, x, lambda r, m, xr, drop: _cache_attention(
                m.attention.self, layer_type, key, xr, k_all[r][li], v_all[r][li], biases[r],
                masks[r], classes[r], cfg, attention_backend, r * m.attention.self.num_heads,
                spatial_bias[r]))
        masked = tuple(_dec_rows_masked(cfg, lt) for lt in cfg.layer_type_list)
        return [MMTCache(k_enc=k, v_enc=v, enc_out=x, enc_bias_cols=bias,
                         ocr_mmt_in=enc["ocr_mmt_in"], spatial_dec_masked=masked)
                for k, v, bias in zip(k_all, v_all, biases)]


def home_device(model) -> torch.device:
    """Where a model's inputs and outputs live: a :class:`TPSAM4C`'s home,
    else its parameters' device."""
    return model.home if isinstance(model, TPSAM4C) else next(model.parameters()).device


def _decode_tables(model: TPSAM4C, batch, backend: str):
    """The step-invariant part of a tensor-parallel decode: the shards'
    encoder caches (through the spatial-attention kernel unless ``backend``
    is ``plain``), ``embed(tokens, t)``, the row embeddings of the previous
    tokens, (B,) or one per beam (B, K), in the compute dtype, and
    ``head(x)``, the scores of final-layer rows (B, D) or (B, K, D), whose
    OCR pointer sums the shards' partial scores on home."""
    cfg = model.params_cfg.mmt
    dtype, home = model.dtype, model.home
    enc = model.encode(batch)
    caches = model.build_mmt_cache(enc, batch, "plain" if backend == "plain" else "kernel")
    pp = model.shards[0].mmt.prev_pred_embeddings
    # step-invariant tables, as fast_decode._prev_pred_tables makes them
    tables = model.answer_tables(torch.float32)
    ocr_emb = pp.ocr_layer_norm(caches[0].ocr_mmt_in).to(torch.float32)
    ocr_begin = cfg.max_seq_length + cfg.max_obj_num
    ocr_out = caches[0].enc_out[:, ocr_begin:ocr_begin + cfg.max_ocr_num].to(dtype)
    keys = model.ptr_project(ocr_out, "key")
    ocr_bias = ((1.0 - batch["pad_ocr_mask"].float()) * MASK_BIAS).to(dtype)
    ans_num = model.num_answers

    def embed(tokens, t):
        return _dec_row_embedding(pp, lambda ids: vocab_parallel_embedding(ids, tables, home),
                                  ocr_emb, ans_num, tokens, t).to(dtype)

    def head(x):
        rows = (1,) * (x.dim() - 2)  # the beam axis, broadcast
        dyn = reduce_sum([torch.matmul(k.view(k.shape[0], *rows, *k.shape[1:]),
                                       q[..., None])[..., 0]
                          for k, q in zip(keys, model.ptr_project(x, "query"))],
                         home) / model.ptr_norm()
        bias = ocr_bias.view(ocr_bias.shape[0], *rows, -1)
        return torch.cat([model.classify(x), dyn + bias], dim=-1)

    return caches, embed, head


def decode_tensor_parallel(model: TPSAM4C, batch, bos_idx: int, backend: str,
                           check_masks: bool, consts=None, eos_idx=None):
    """``fast_decode._greedy_decode`` of a tensor-parallel model with a
    resolved ``backend``: ``plain`` and ``xla_early`` (with ``eos_idx``)
    run their PyTorch steps on each shard's heads, ``fused`` its kernel and
    ``mega`` the decode step's per-layer shard entries on each shard, the
    partials summed on home (``consts``: ``decode_consts()``). The shards'
    tables, caches and decoder K/V stay on their devices; the scores, ids
    and the number of steps run come back on home."""
    cfg = model.params_cfg.mmt
    home, devices, tp = model.home, model.devices, model.tp
    caches, embed, head = _decode_tables(model, batch, backend)
    b, t_max = batch["question_indices"].shape[0], cfg.num_decoding_steps
    n_layers = len(cfg.layer_type_list)

    if backend not in KERNEL_STEP_BACKENDS:
        dec_kv = [_row_kv(cfg, c.k_enc, b, tp) for c in caches]

        def step(x, t):
            col_bias = [_dec_col_bias(cfg, t, dev) for dev in devices]
            x = x[:, None]
            for li, (layer_type, _, layers) in enumerate(model._mmt_layers()):
                x = model._layer(layers, x, lambda r, m, xr, drop: _one_row_context(
                    m.attention.self, layer_type, cfg, caches[r], li, xr, dec_kv[r][li], t,
                    col_bias[r], r * m.attention.self.num_heads))
            return x[:, 0]

        return _greedy_steps(cfg, b, home, bos_idx, embed, head, step, eos_idx)

    seg = _seg_lens(batch, validate=check_masks)
    segs = broadcast(seg, devices)
    if consts is None:
        consts = model.decode_consts()
    k_dec = [c.k_enc.new_zeros(n_layers, b, t_max, c.k_enc.shape[-1]) for c in caches]
    v_dec = [c.k_enc.new_zeros(n_layers, b, t_max, c.k_enc.shape[-1]) for c in caches]
    steps = [torch.arange(t_max, dtype=torch.int32, device=dev) for dev in devices]

    def step(x, t):
        return _decode_one_row_fused(cfg, consts, caches, segs, x, k_dec, v_dec, t,
                                     [s[t:t + 1] for s in steps],
                                     shard_entries=backend == "mega")

    return _greedy_steps(cfg, b, home, bos_idx, embed, head, step)


def beam_tensor_parallel(model: TPSAM4C, batch, beam_size: int, backend: str):
    """The parts of ``fast_decode.beam_search_decode_fast`` for a
    tensor-parallel model with a resolved ``backend``: (embed, head, step,
    reorder). ``step(x, t)`` runs the beams' rows (B, K, D) through every
    layer, each shard attending over its own heads against its cache
    (``fast_decode._beam_context``) with the shards' out-projection and FFN
    summed on home (:meth:`TPSAM4C._layer`); ``reorder(prev_beam)`` gathers
    each shard's beams' decoder K/V on its own device."""
    cfg = model.params_cfg.mmt
    caches, embed, head = _decode_tables(model, batch, backend)
    b, k, t_max = batch["question_indices"].shape[0], beam_size, cfg.num_decoding_steps
    d = cfg.hidden_size
    dec_kv = []  # per shard, per layer (k, v) of shape (B, K, H/tp, T, hd)
    for cache in caches:
        bufs = []
        for lt in cfg.layer_type_list:
            h = layer_heads(cfg, lt)
            shape = (b, k, h // model.tp, t_max, d // h)
            bufs.append((cache.k_enc.new_zeros(shape), cache.k_enc.new_zeros(shape)))
        dec_kv.append(bufs)

    def step(x, t):
        col_bias = [_dec_col_bias(cfg, t, dev) for dev in model.devices]
        for li, (layer_type, _, layers) in enumerate(model._mmt_layers()):
            x = model._layer(layers, x, lambda r, m, xr, drop: _beam_context(
                m.attention.self, layer_type, cfg, caches[r], li, xr, dec_kv[r][li], t,
                col_bias[r], r * m.attention.self.num_heads))
        return x

    def reorder(prev_beam):
        dec_kv[:] = [reorder_beams(bufs, prev_beam) for bufs in dec_kv]

    return embed, head, step, reorder
