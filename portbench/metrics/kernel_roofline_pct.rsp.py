"""kernel_roofline_pct.rsp: the port kernels' bound time (bytes their
inputs need at the card's peak bandwidth) over their device time, from
the traced window: the tagged fixpoint's ``filter_mask`` premise scans
(valid rows alone) and ``merge_path_join`` joins."""

from portbench.metrics.kernel_bytes import roofline_pct


def read(ctx):
    return roofline_pct(ctx)
