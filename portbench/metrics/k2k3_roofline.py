"""K2 and K3 (``ops/kernels/resize.py``, ``csrc/resize.cu``; one kernel
template, a K2 and a K3 launch a program): their launches wholly inside the
window, each pair bounded by ``roofline.preprocess_cost`` and
``roofline.upsample_cost`` at the program's shapes, over their measured
time, in %."""

from portbench import kernels, roofline, trace


def read(rec, metric):
    events, peak = rec.events(), roofline.peaks(rec.device_name)
    if not events or peak is None:
        return None
    t0, t1 = rec.window
    launches = trace.whole_inside(events, t0, t1, kernels.is_resize)
    if not launches:
        return None
    cfg, b = rec.run.config, rec.out.rows_per_program
    in_hw, net_hw = tuple(cfg["input_hw"]), tuple(cfg["net_hw"])
    out_bytes = 1 if rec.out.output == "u8" else 4
    pair = [roofline.preprocess_cost(b, in_hw, net_hw), roofline.upsample_cost(b, net_hw, in_hw, out_bytes)]
    per_launch = sum(roofline.bound_s(f, nb, peak["fma_flops_per_s"], peak["hbm_bytes_per_s"])
                     for f, nb in pair) / 2
    return 100.0 * len(launches) * per_launch / sum(e - s for _, s, e in launches)
