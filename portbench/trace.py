"""What a ``--trace 1`` run reads besides the spans: the profiler's
timeline of the window (device busy time, idle gaps and what the host did
in them, the longest device operations, the port's kernels' device time)
and the bytes each launch of a port kernel needed, from the frozen byte
functions."""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from portbench.metrics import kernel_bytes as KB


class KernelBytes:
    """Wraps the port's kernel entries for one window: each launch adds the
    bytes its inputs need (device scalars, summed once the window has
    closed, so the window has no extra host sync).  The fixpoint's premise
    scans (``device_fixpoint._scan_premise``) hand ``filter_mask`` a whole
    fact or delta buffer and hold its valid mask apart; a filter launched
    from one counts the valid rows alone (one extra device reduction a
    scan)."""

    def __init__(self):
        self.parts: Dict[str, list] = {k: [] for k in KB.KERNELS}
        self._undo: List[tuple] = []
        self._scan = None  # (the scanned subject column, its valid mask)

    def __enter__(self):
        from kolibrie_tpu_torch.ops import kernels as K
        from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

        pairs = [
            (K.merge_path, self._wrap("merge_path_join", K.merge_path, KB.merge_path_bytes)),
            (K.lex_probe_select, self._wrap("lex_probe_select", K.lex_probe_select, KB.select_bytes)),
            (K.lex_probe_validate, self._wrap("lex_probe_validate", K.lex_probe_validate,
                                              KB.validate_bytes)),
            (K.filter_mask, self._wrap("filter_mask", K.filter_mask, self._filter_bytes)),
            (K.tag_combine, self._wrap("tag_combine", K.tag_combine, KB.tag_bytes)),
            (FX._scan_premise, self._scan_wrap(FX._scan_premise)),
        ]
        by_id = {id(fn): (fn, wrapped) for fn, wrapped in pairs}
        for mod in list(sys.modules.values()):
            if not getattr(mod, "__name__", "").startswith("kolibrie_tpu_torch"):
                continue
            for attr, val in list(vars(mod).items()):
                fn, wrapped = by_id.get(id(val), (None, None))
                if fn is val:
                    setattr(mod, attr, wrapped)
                    self._undo.append((mod, attr, val))
        return self

    def _wrap(self, name, fn, count):
        parts = self.parts[name]

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if _on_card(args):
                parts.append(count(args, kw))
            return out

        return wrapped

    def _scan_wrap(self, fn):
        def scan(prem, cols, valid):
            outer, self._scan = self._scan, (cols[0], valid)
            try:
                return fn(prem, cols, valid)
            finally:
                self._scan = outer

        return scan

    def _filter_bytes(self, args, kw):
        scan = self._scan
        if scan is not None and args[0] is scan[0]:
            return KB.filter_bytes(args, kw, rows=scan[1].sum())
        return KB.filter_bytes(args, kw)

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()
        return False

    def totals(self) -> Dict[str, Tuple[int, int]]:
        """``{kernel: (launches, bytes)}``."""
        out = {}
        for name, parts in self.parts.items():
            out[name] = (len(parts), int(sum(int(p) for p in parts)))
        return out


def _on_card(args) -> bool:
    import torch

    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device.type == "cuda"
    return False


class Timeline:
    """The profiler over one window, reduced once it has closed.  The
    window is the ``portbench.window`` mark, or where a loop marks its
    timed work apart (``work()``: the materialisation jobs, without the
    seeding between them), the union of those marks."""

    MARK = "portbench.window"
    WORK = "portbench.work"

    def __init__(self):
        self.prof = None
        self.mark = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark = record_function(self.MARK)
        self.mark.__enter__()
        return self

    def work(self):
        from torch.profiler import record_function

        return record_function(self.WORK)

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def reduce(self, spans=()) -> dict:
        return reduce_events(_events(self.prof), spans)


def reduce_events(events, spans=()) -> dict:
    """Device intervals clipped to the window: busy seconds as the union of
    every device operation's interval, the longest device operations by
    name, the port kernels' device seconds, and the longest idle gaps, each
    with what the host was doing at its middle: the innermost program span,
    else the innermost profiled host operation.  ``events`` are ``(name,
    start_ns, duration_ns, "cuda" | "cpu", is_annotation)``; ``spans`` the
    program's span dicts (``start_s`` on the same wall clock)."""
    dev, host, marks, work = [], [], [], []
    for name, start, dur, kind, note in events:
        if note:
            # user annotations (the marks, record_function ranges) are
            # drawn on the device's row too: not device work
            if kind == "cpu" and name == Timeline.MARK:
                marks.append((start, start + dur))
            elif kind == "cpu" and name == Timeline.WORK:
                work.append((start, start + dur))
        elif kind == "cuda":
            dev.append((start, start + dur, name))
        elif kind == "cpu":
            host.append((start, start + dur, name))
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": [],
                "kernel_s": {}, "ops": 0}
    windows = sorted(work) or marks[:1] or [(min(d[0] for d in dev), max(d[1] for d in dev))]
    dev.sort()
    busy, gaps, by_name = 0, [], {}
    kernel_ns: Dict[str, int] = {k: 0 for k in KB.KERNELS}
    i = 0
    for lo, hi in windows:
        while i < len(dev) and dev[i][1] <= lo:
            i += 1
        j, cur = i, lo  # cur: the end of device activity so far
        while j < len(dev) and dev[j][0] < hi:
            s, e, name = dev[j]
            s, e = max(s, lo), min(e, hi)
            j += 1
            if e <= s:
                continue
            by_name[name] = by_name.get(name, 0) + (e - s)
            for k, sym in KB.KERNELS.items():
                if sym in name:
                    kernel_ns[k] += e - s
            if s > cur:
                gaps.append((s - cur, cur, s))
            busy += max(0, e - max(s, cur))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((hi - cur, cur, hi))
    gaps.sort(reverse=True)
    named = [(int(sp["start_s"] * 1e9), int(sp["start_s"] * 1e9 + sp["dur_ms"] * 1e6),
              sp["name"]) for sp in spans]
    top_gaps = []
    for length, a, b in gaps[:10]:
        mid = (a + b) // 2
        inner = [h for h in named if h[0] <= mid <= h[1]] or [h for h in host if h[0] <= mid <= h[1]]
        what = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host"
        top_gaps.append([what, length / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy / 1e9,
        "window_s": sum(hi - lo for lo, hi in windows) / 1e9,
        "device_ops": [[n, t / 1e9] for n, t in ops],
        "idle_gaps": top_gaps,
        "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
        "ops": len(dev),
    }


def _events(prof) -> List[tuple]:
    """``(name, start_ns, duration_ns, device_type, is_annotation)`` of
    every profiled event, on the profiler's clock."""
    from torch.autograd import DeviceType

    kinds = {DeviceType.CUDA: "cuda", DeviceType.CPU: "cpu"}
    kr = prof.profiler.kineto_results
    return [(e.name(), e.start_ns(), e.duration_ns(), kinds.get(e.device_type(), "other"),
             e.is_user_annotation()) for e in kr.events()]

