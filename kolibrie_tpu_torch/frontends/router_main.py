"""Front-router entrypoint: ``python -m kolibrie_tpu_torch.frontends.router_main``.

Boots the template-affinity router (:mod:`kolibrie_tpu_torch.replication.router`)
in front of a fleet of replica HTTP servers.  The fleet is configured by
environment, matching the server-side convention in ``http_server.serve``:

- ``KOLIBRIE_REPLICAS``   — ``name=http://host:port,name=url,...`` (required)
- ``KOLIBRIE_ROUTER_PROBE_INTERVAL_S`` — health-probe cadence (default 0.5)
- ``KOLIBRIE_ROUTER_AUTO_PROMOTE``     — ``0`` disables the promotion
  supervisor (default on: a dead primary is replaced by the follower with
  the highest durable watermark)

This module deliberately imports no query-engine code: the router process
only speaks HTTP and JSON, so it boots in milliseconds and survives
engine-side crashes unaffected — which is the whole point of putting it
in front.

Copy of ``kolibrie_tpu/frontends/router_main.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import List, Tuple

from kolibrie_tpu_torch.obs import log as obslog
from kolibrie_tpu_torch.replication.router import make_router

_log = obslog.get_logger("router_main")


def parse_replicas(spec: str) -> List[Tuple[str, str]]:
    """``"a=http://h:1,b=http://h:2"`` → ``[("a", "http://h:1"), ...]``.
    Raises ValueError on malformed entries — a router silently pointed at
    nothing would "work" while serving 503s forever."""
    out: List[Tuple[str, str]] = []
    for chunk in spec.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, sep, url = chunk.partition("=")
        if not sep or not name.strip() or not url.strip().startswith("http"):
            raise ValueError(
                f"bad replica spec {chunk!r}; want name=http://host:port"
            )
        out.append((name.strip(), url.strip().rstrip("/")))
    if not out:
        raise ValueError("KOLIBRIE_REPLICAS is empty")
    return out


def serve(host: str = "127.0.0.1", port: int = 8090) -> None:
    spec = os.environ.get("KOLIBRIE_REPLICAS", "")
    replicas = parse_replicas(spec)
    probe_s = float(os.environ.get("KOLIBRIE_ROUTER_PROBE_INTERVAL_S", "0.5"))
    auto = os.environ.get("KOLIBRIE_ROUTER_AUTO_PROMOTE", "1") != "0"
    httpd, core = make_router(
        replicas,
        host=host,
        port=port,
        probe_interval_s=probe_s,
        auto_promote=auto,
    )
    bound = httpd.server_address
    obslog.set_identity("router", bound[1])
    _log.info(
        "router listening",
        url=f"http://{bound[0]}:{bound[1]}",
        replicas=len(replicas),
        auto_promote=auto,
    )
    stop = threading.Event()

    def _term(_sig, _frm):
        stop.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        httpd.serve_forever(poll_interval=0.2)
    finally:
        core.stop()
        httpd.server_close()


if __name__ == "__main__":
    _host = sys.argv[1] if len(sys.argv) > 1 else "127.0.0.1"
    _port = int(sys.argv[2]) if len(sys.argv) > 2 else 8090
    serve(_host, _port)
