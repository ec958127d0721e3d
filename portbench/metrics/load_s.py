"""load_s: host seconds of the store's bulk load, synchronised: the
program's store built from the generated columns and term list, its
compaction, and the upload of its first device order."""


def read(ctx):
    return ctx.get("load_s")
