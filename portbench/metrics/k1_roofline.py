"""K1 (``ops/kernels/attention.py``, ``csrc/attention.cu``): its launches
wholly inside the window, each bounded by ``roofline.attention_cost`` at the
program's shape, over their measured time, in %."""

from portbench import kernels, roofline, trace


def read(rec, metric):
    events, peak = rec.events(), roofline.peaks(rec.device_name)
    if not events or peak is None:
        return None
    t0, t1 = rec.window
    k1 = trace.whole_inside(events, t0, t1, kernels.is_k1)
    if not k1:
        return None
    cfg = rec.run.config
    heads = cfg["num_attention_heads"]
    n = rec.run.tokens
    flops, nbytes = roofline.attention_cost(rec.out.rows_per_program, heads, n, n,
                                            cfg["hidden_size"] // heads, rec.run.elem_bytes)
    bound = roofline.bound_s(flops, nbytes, peak["matmul_flops_per_s"][cfg["dtype"]], peak["hbm_bytes_per_s"])
    return 100.0 * len(k1) * bound / sum(e - s for _, s, e in k1)
