"""The encoder's share of the card's dense peak in the cell's dtype, on
its own device time: the FLOPs a frame's encoder convs need
(``perfbench/work``'s ``encoder.*`` convs) times the span window's
frames, over the device seconds of the kernels launched inside the
program's ``fastdepth.encoder`` spans (``perfbench/spans.py``), over the
published peak.  The kernels are the convs and everything else the
encoder launches (bias adds, clamps).  Nothing to read where no kernel
fell under the span."""

from perfbench import spans


def read(run):
    return spans.conv_mfu_pct(run, spans.ENCODER, encoder=True)
