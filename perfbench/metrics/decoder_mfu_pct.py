"""The decoder's share of the card's dense peak in the cell's dtype, on
its own device time: the FLOPs a frame's convs after the encoder need
(``perfbench/work``'s convs other than ``encoder.*``: the bridge, the
levels and the head, the inserted zeros' multiply-adds left out) times
the span window's frames, over the device seconds of the kernels
launched inside the program's ``fastdepth.decoder`` spans
(``perfbench/spans.py``), over the published peak.  Nothing to read
where no kernel fell under the span."""

from perfbench import spans


def read(run):
    return spans.conv_mfu_pct(run, spans.DECODER, encoder=False)
