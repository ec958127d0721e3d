"""kernel_roofline_pct.analytic: the port kernels' bound time (bytes their
inputs need at the card's peak bandwidth) over their device time, from
the traced window."""

from portbench.metrics.kernel_bytes import roofline_pct


def read(ctx):
    return roofline_pct(ctx)
