"""Helpers for the port's serving tests: both packages' HTTP servers (and
routers) in this process on ephemeral ports, the same requests sent to
each, and their JSON compared with what differs by nature masked."""

from __future__ import annotations

import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

# keys whose values are wall times, trace ids or on-disk locations
MASKED_KEYS = frozenset({
    "execution_time_ms", "trace_id", "path", "trace_dir", "ms",
    "finalize_ms", "last_applied_unix", "probe_age_s",
})


def masked(value):
    """``value`` with every :data:`MASKED_KEYS` entry replaced by a marker."""
    if isinstance(value, dict):
        return {k: ("<masked>" if k in MASKED_KEYS else masked(v)) for k, v in value.items()}
    if isinstance(value, list):
        return [masked(v) for v in value]
    return value


# a template fingerprint, bare or kind-prefixed ("device:<fp>")
_TEMPLATE_KEY = re.compile(r"^(\w+:)?[0-9a-f]{40}")


def key_shape(value):
    """The nested key sets of a JSON value.  Keys that are template
    fingerprints fold into one ``<template>`` key (which templates a
    process-wide block lists depends on what else the process ran), and a
    list is just a list."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            out.setdefault("<template>" if _TEMPLATE_KEY.match(k) else k, key_shape(v))
        return out
    if isinstance(value, list):
        return "list"
    return type(value).__name__


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(httpd) -> str:
    """Serve ``httpd`` on a daemon thread; its base URL."""
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def join_all(threads, timeout_s=120.0) -> None:
    """Join every thread within one shared bound: a client thread still
    running after it fails the test instead of holding its worker."""
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"threads still running after {timeout_s} s: {alive}"


def post(base, path, payload, headers=None, raw=None, timeout=60):
    """``(status, json body, headers)`` of a POST; HTTP errors included."""
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers=h, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def get(base, path, headers=None, timeout=60):
    """``(status, body bytes, headers)`` of a GET; HTTP errors included."""
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def wait_ready(base, timeout_s=60.0) -> dict:
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        try:
            st, body, _ = get(base, "/healthz", timeout=5)
            last = json.loads(body)
            if st == 200 and last.get("status") == "ready":
                return last
        except (urllib.error.URLError, OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"{base} never became ready: {last}")


def wait_applied(base, segment, timeout_s=60.0) -> None:
    """Until the follower at ``base`` has applied WAL segment ``segment``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        _, body, _ = get(base, "/healthz")
        repl = json.loads(body).get("replication") or {}
        if (repl.get("watermark") or {}).get("applied_segment", 0) >= segment:
            return
        time.sleep(0.05)
    raise AssertionError(f"{base} never applied segment {segment}")


def sse_first(base, session_id, timeout=30) -> dict:
    """The first ``data:`` payload of a session's SSE stream."""
    req = urllib.request.Request(base + f"/rsp/events/{session_id}")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        line = resp.readline().decode()
    assert line.startswith("data: "), line
    return json.loads(line[len("data: "):])


def prom_families(text: str) -> set:
    """Family names of a Prometheus text exposition (its TYPE lines)."""
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")}
