"""Faults planted in the program, for the checks' tests and for readings on
the card (``calibrate.py --fault``). Serving: the served model's transformer
layers lose their biases, or their LayerNorms' scale and shift, after its
weights are loaded, as a kernel that dropped the bias add or the
LayerNorm's affine would. Training: the loss takes half of the batch and
its mean over that half."""

from __future__ import annotations


def _affine(touches, value):
    def plant(setattr_):
        import torch

        from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C

        load = SAM4C.load_state_dict

        def faulty(self, state_dict, *args, **kwargs):
            out = load(self, state_dict, *args, **kwargs)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    if touches(name):
                        # a LayerNorm's scale back to 1 and its shift to 0
                        p.fill_(value if value is not None else float(name.endswith(".weight")))
            return out

        setattr_(SAM4C, "load_state_dict", faulty)
    return plant


def _half_batch(setattr_):
    from sam_textvqa_tpu_torch.training import step

    loss = step.m4c_decoding_bce_with_mask

    def half(scores, targets, mask):
        n = scores.shape[0] // 2
        return loss(scores[:n], targets[:n], mask[:n])

    setattr_(step, "m4c_decoding_bce_with_mask", half)


#: serving faults: the weights as the program holds them
AFFINE = {
    "mmt_bias_left_out": _affine(lambda n: n.startswith("mmt.encoder.") and n.endswith(".bias")
                                 and ".LayerNorm." not in n, 0.0),
    "mmt_layernorm_affine_left_out": _affine(lambda n: n.startswith("mmt.encoder.")
                                             and ".LayerNorm." in n, None),
}
FAULTS = {**AFFINE, "half_batch_left_out": _half_batch}


def plant(fault: str, monkeypatch=None) -> None:
    """Plant ``fault`` for the rest of the process; with ``monkeypatch``
    (pytest's), undone at the test's end."""
    FAULTS[fault](monkeypatch.setattr if monkeypatch is not None else setattr)
