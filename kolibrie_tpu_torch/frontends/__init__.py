"""User-facing frontends: command-line interface and HTTP server.

Parity: ``cli/src/main.rs`` (clap CLI) and
``kolibrie-http-server/src/main.rs`` (hand-rolled HTTP server with /query,
/rsp-query, /rsp/register, /rsp/push, SSE /rsp/events/<id>, playground).

Copy of ``kolibrie_tpu/frontends/__init__.py`` for the PyTorch port, its imports
rewritten.
"""


def cli_main(argv=None):
    """Lazy forward to :func:`kolibrie_tpu_torch.frontends.cli.main` (keeps
    ``python -m kolibrie_tpu_torch.frontends.cli`` free of double-import warnings)."""
    from kolibrie_tpu_torch.frontends.cli import main

    return main(argv)
