"""A cell shrunk to a size the CPU runs in seconds, for the tests: the same
files, with the widths and counts cut and the program in float32."""

from __future__ import annotations

import copy

from benchmark.harness.cell import load_cell


def tiny_cell(workload: str, dtype: str = "float32") -> dict:
    cell = copy.deepcopy(load_cell(workload))
    c = cell["config"]
    c["assumed"]["compute_dtype"] = dtype
    # the full width's logit scale (0.1 x sqrt(768)) at hidden 96
    c["assumed"]["init_std_serve"] = 0.3
    c["assumed"]["init_std_affine_serve"] = 0.3
    c.update(max_seq_length=8, max_obj_num=10, max_ocr_num=6, num_answers=40, batch_size=8,
             num_workers=2, train_split_size=24)
    m = c["SA-M4C"]
    m.update(hidden_size=96, ptr_query_size=96, intermediate_size=128, num_hidden_layers=1,
             num_spatial_layers=1, layer_type_list=["n", "s"], mix_list=["none", m["mix_list"][-1]],
             max_seq_length=8, max_obj_num=10, max_ocr_num=6, num_decoding_steps=4)
    c["mix_list"] = m["mix_list"]
    t = c["TextBERT"]
    t.update(hidden_size=96, num_hidden_layers=1, intermediate_size=128)
    tr = cell["traffic"]
    if tr["kind"] == "serve":
        tr["engine"]["buckets"] = [1, 4]
        if "rate_per_s" in tr["arrivals"]:
            tr["arrivals"]["rate_per_s"] = 400.0
        tr["pool"].update(requests=24, question_max=8, obj_max=10, ocr_short_max=4, ocr_max=6)
        tr.update(warmup_s=0.2, trace_slice_s=0.5)
        tr["check"].update(requests=8, block=8, min_tokens=8)
    else:
        tr["batch"] = 8
        tr["data"].update(question_max=8, obj_max=10, ocr_short_max=4, ocr_max=6,
                          distinct_words=16, answer_max=3)
        tr.update(warmup_steps=3, trace_slice_s=0.5)
    return cell
