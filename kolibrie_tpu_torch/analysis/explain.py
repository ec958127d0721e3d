"""``--explain KLxxx``: rule documentation at the terminal.

Every rule gets at least its registered one-liner plus the docstring of
the module that defines it (the rule families keep their design notes
there).  The rules people actually argue with — the dataflow taint and
race families — additionally carry a curated fixture and fix recipe, so
"why is kolint yelling" is answerable without opening docs/ANALYSIS.md.
"""

from __future__ import annotations

import sys
import textwrap
from typing import Dict, Optional

# rule id → (example fixture, fix recipe)
_CURATED: Dict[str, tuple] = {
    "KL111": (
        """\
        @jax.jit
        def hot(x):
            y = x * 2            # y derives from the traced param
            if y.sum() > 0:      # KL111: host `if` on a traced value
                return y
            return -y
        """,
        """\
        Branch on-device instead of on-host: jnp.where(cond, a, b) for
        element selection, lax.cond for whole-branch dispatch.  If the
        decision is genuinely host-side (config, capacity), hoist it out
        of the jit region and pass the result in as a static argument.
        """,
    ),
    "KL112": (
        """\
        def serve(rows):
            n = len(rows)             # per-call data…
            return kernel(rows, cap=n)  # KL112: …reaching static cap
        # (kernel declares cap in static_argnums)
        """,
        """\
        Every distinct static value compiles a new program.  Round the
        value through a capacity class first — cap=round_cap(len(rows))
        / pow2 bucket — so thousands of request sizes share a handful
        of compiled templates (the template-cap protocol).  Inside jit,
        use a traced operand's .shape: it is already a trace-time
        constant.
        """,
    ),
    "KL311": (
        """\
        class Sampler:
            def __init__(self):
                self.count = 0          # shared with the daemon below
            def _run(self):             # Thread(target=self._run)
                self.count += 1         # KL311: unguarded shared write
            def stats(self):
                return self.count
        """,
        """\
        Pick ONE named lock, hold it at every access, and annotate the
        field:  self.count = 0  # guarded by: _lock.  The annotation
        moves enforcement to KL301 (lexical) and the runtime sanitizer
        (KOLIBRIE_DEBUG_LOCKS=1).  += is a read-modify-write that drops
        increments under contention — GIL atomicity is not a contract.
        If the idiom is genuinely safe (startup-once publish, atomic
        rebind of an immutable snapshot), say WHY in a suppression:
        # kolint: ignore[KL311] <reason>.
        """,
    ),
    "KL312": (
        """\
        def promote(self):
            with self.lock:
                self.promotions += 1
            self.last_ms = elapsed      # KL312: slipped out of the lock
        """,
        """\
        Some accesses hold a lock, this one doesn't — usually a write
        that drifted out of its `with` block during a refactor, which
        makes the OTHER sites' locking theater.  Move the access under
        the same lock; when the lock-free read is intentional (snapshot
        idiom), suppress with the argument, or annotate the field
        `# guarded by: <lock>` and keep reads free (`writes` mode).
        """,
    ),
}


def explain(rule_id: str) -> Optional[str]:
    """Render the explanation text for ``rule_id``, or None if unknown."""
    from kolibrie_tpu_torch.analysis.core import (
        META_PARSE,
        META_SUPPRESSION,
        RULES,
    )

    meta = {
        META_SUPPRESSION: "suppression directive malformed "
        "(missing reason / unknown rule id)",
        META_PARSE: "file does not parse",
    }
    if rule_id in meta:
        return f"{rule_id}: {meta[rule_id]}\n"
    if rule_id not in RULES:
        return None
    desc, fn = RULES[rule_id]
    out = [f"{rule_id}: {desc}", ""]
    curated = _CURATED.get(rule_id)
    if curated:
        fixture, recipe = curated
        out += [
            "Example:",
            textwrap.indent(textwrap.dedent(fixture).rstrip(), "    "),
            "",
            "Fix:",
            textwrap.indent(
                textwrap.fill(
                    " ".join(textwrap.dedent(recipe).split()), width=68
                ),
                "    ",
            ),
            "",
        ]
    mod = sys.modules.get(fn.__module__)
    doc = (mod.__doc__ or "").strip() if mod else ""
    if doc:
        out += [f"Family notes ({fn.__module__.rsplit('.', 1)[-1]}):", ""]
        out.append(textwrap.indent(doc, "    "))
        out.append("")
    return "\n".join(out)
