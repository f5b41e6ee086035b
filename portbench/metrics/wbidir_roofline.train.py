"""wbidir_roofline.train: the bidirectional windowed GRU layer 0's kernel
calls, each direction's forward (``gru_wfwd``) and its backward with the
frames' gradient (``gru_wbwd`` with ``need_dx``), their least time over
their device time, %, over the profiled train steps.

A call's least time is ``families/b2t24_bigru_flops.py`` (the forward) or
``families/b2t_gru_flops.py`` (the backward) at its span's shapes: every
product of the call at the rate a 3xTF32 product can reach (165 TFLOP/s
for a float32 operand, 247.5 for a bf16 one), or the work's bytes at 3.35
TB/s where that is longer. None where no windowed call runs reversed (a
program without the bidirectional windowed layer).
"""

from portbench.core.spec import reader
from portbench.families.b2t24_bigru_flops import wbidir_fwd_least_s
from portbench.families.b2t_gru_flops import frame_grad_least_s


def read(rec):
    if rec.get("kind") != "train":
        return None
    calls = [r for r in reader("gru_roofline.train").in_window(
        rec, ("gru_wfwd", "gru_wbwd")) if r["device_ms"] is not None]
    if not any(r["attrs"].get("reverse") for r in calls):
        return None
    least = spent = 0.0
    for r in calls:
        if r["name"] == "gru_wfwd":
            least += wbidir_fwd_least_s(r["attrs"])
        elif r["attrs"].get("need_dx"):
            least += frame_grad_least_s(r["attrs"])
        else:
            continue
        spent += r["device_ms"] / 1e3
    return 100.0 * least / spent if spent > 0 else None
