"""K6 (csrc/shading_eval.cu, kernel `shade_eval_kernel`) in the scored
views of the relighting evaluation: its roofline share, in %: the least
time the H100 needs for the counted bytes and operations of its launches
(`work_eval.k6_work`, at the configuration's S) over their device time."""
from benchmark.work import bound_s


def read(t):
    counted = t.work_sum("k6")
    dev = t.device_s_matching("shade_eval_kernel")
    if t.kind != "frame" or counted is None or dev <= 0:
        return None
    return 100.0 * bound_s(*counted) / dev
