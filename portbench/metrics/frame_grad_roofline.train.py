"""frame_grad_roofline.train: the ``gru_wbwd`` calls that form the frames'
gradient (``need_dx``), their least time over their device time, %, over
the profiled train steps.

A call's least time is ``families/b2t_gru_flops.py:frame_grad_least_s``
at its span's shapes: every product of the windowed layer's backward with
the windows' dx and its fold onto the frames, each at the rate a 3xTF32
product can reach (165 TFLOP/s for a float32 operand, 247.5 for a bf16
one), or the work's bytes at 3.35 TB/s where that is longer. None where
the port keeps no such span (a windowed layer whose frames are data).
"""

from portbench.core.spec import reader
from portbench.families.b2t_gru_flops import frame_grad_least_s


def frame_grad_roofline(rec: dict, kind: str):
    if rec.get("kind") != kind:
        return None
    least = spent = 0.0
    for r in reader("gru_roofline.train").in_window(rec, ("gru_wbwd",)):
        if r["attrs"].get("need_dx") and r["device_ms"] is not None:
            least += frame_grad_least_s(r["attrs"])
            spent += r["device_ms"] / 1e3
    return 100.0 * least / spent if spent > 0 else None


def read(rec):
    return frame_grad_roofline(rec, "train")
