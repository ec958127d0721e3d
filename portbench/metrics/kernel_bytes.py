"""The bytes each launch of a port kernel needs, from its inputs.

Frozen copies of ``chip_smoke.py``'s byte functions, counting what the
inputs fill rather than the capacity they were given: the merge path
counts the output slots its matches fill, not every one of ``cap``, and a
filter over a padded buffer counts the rows that hold facts, so a smaller
capacity reads as less waste and never as more than the bound.
Each function returns a 0-dim device tensor or a Python int, so a traced
window pays no host sync for it; the sums are read once it has closed.
Each input byte is counted once as read and each output byte once as
written.  Not a metric itself: ``kernel_roofline_pct.*`` read it."""

from __future__ import annotations

#: CUDA symbol (or its prefix) of each port kernel, as the profiler names it
KERNELS = {
    "merge_path_join": "merge_path_join_kernel",
    "lex_probe_select": "lex_probe_select_kernel",
    "lex_probe_validate": "lex_probe_validate_kernel",
    "filter_mask": "filter_mask_kernel",
    "tag_combine": "tag_combine_kernel",
}


def merge_path_bytes(args, kw=None):
    """``merge_path(lidx_c, low_c, cum, total, ln, rn, cap)``: the
    compacted left rows that feed the filled slots (cum, low, lidx: 24
    bytes each) read once; li, ri (16 bytes) and valid (1 byte) written
    for each filled slot, ``min(total, cap)``."""
    import torch

    _lidx, _low, cum, total, _ln, _rn, cap = args
    slots = torch.clamp(total.reshape(()), max=cap)
    last = (slots - 1).clamp(min=0).reshape(1)
    rows = torch.searchsorted(cum, last, right=True)[0] + 1
    rows = torch.where(slots > 0, rows, torch.zeros_like(rows))
    return 24 * rows + 17 * slots


def select_bytes(args, kw=None):
    """``lex_probe_select(kk, ch, in_range, accessors)``, per slot: kk, ch
    (8 bytes each) and in_range (1) read, the chosen accessor's range width
    and its base or delta value (16) read, val (8), ok and is_base (2)
    written; and the value's predecessor (8) for the slots that do not
    start their range."""
    import torch

    kk, ch, _in_range, acc = args
    p = kk.shape[0]
    nb = torch.stack([a[0] for a in acc]).gather(0, ch.unsqueeze(0))[0]
    needs_prev = torch.where(kk < nb, kk != 0, kk != nb).sum()
    return p * (8 + 8 + 1 + 16 + 10) + 8 * needs_prev


def validate_bytes(args, kw=None):
    """``lex_probe_validate(ok, is_base, ch, accessors)``: ok read and the
    mask written (1 byte each) for every slot; is_base (1) and ch (8), and
    every accessor's six ranges (48) and sentinel flag (1), only for the
    slots still valid."""
    ok, _isb, _ch, acc = args
    p = ok.shape[0]
    live = ok.sum()
    return p * 2 + live * (1 + 8) + live * 49 * len(acc)


def filter_bytes(args, kw=None, rows=None):
    """``filter_mask(s, p, o, s_const, p_const, o_const, o_op, o_cmp)``: 8
    bytes a row of each column an active clause reads (the object once, for
    its constant and its comparison), and the 1-byte mask written.  ``rows``:
    the rows that hold facts, where the columns are a padded buffer whose
    valid mask the caller holds (the fixpoint's premise scans); every row
    otherwise."""
    names = ("s_const", "p_const", "o_const", "o_op", "o_cmp")
    given = dict(zip(names, args[3:]))
    given.update(kw or {})
    cols = (
        int(given.get("s_const", -1) >= 0)
        + int(given.get("p_const", -1) >= 0)
        + int(given.get("o_const", -1) >= 0 or given.get("o_op", -1) >= 0)
    )
    return (args[0].shape[0] if rows is None else rows) * (8 * cols + 1)


def tag_bytes(args, kw=None):
    """``tag_combine(a, b, op)``: two f32 inputs read, one f32 written."""
    return args[0].shape[0] * 12


def roofline_pct(ctx):
    """The port kernels' share of their byte bound over the window: the
    sum over launches of bytes / peak bandwidth, over the sum of those
    kernels' device time.  None without a launch."""
    kernels, timeline = ctx.get("kernels"), ctx.get("timeline")
    if not kernels or not timeline:
        return None
    device_s = sum(timeline["kernel_s"].get(k, 0.0) for k in KERNELS)
    launches = sum(n for n, _b in kernels.values())
    if not launches or device_s <= 0:
        return None
    bound_s = sum(b for _n, b in kernels.values()) / ctx["peaks"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / device_s
