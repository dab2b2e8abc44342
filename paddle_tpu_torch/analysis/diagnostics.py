"""Structured diagnostics shared by the analysis passes (the port of
``paddle_tpu/analysis/diagnostics.py``, copied).

One flat record type instead of per-pass ad-hoc tuples, so the CLIs, the
inline ``Executor.run`` hook, and the tests all consume the same shape.
Severity ordering matters: ``ERROR`` is "this program cannot run (or the
invariant is violated)", ``WARNING`` is "suspicious but executable",
``INFO`` is context.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


class Severity(enum.IntEnum):
    """Ordered so ``max(diags, key=severity)`` and threshold filters work."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "ERROR", not "Severity.ERROR"
        return self.name


@dataclass(frozen=True)
class Diagnostic:
    """One finding.

    ``code`` is the stable machine-readable class ("def-before-use",
    "shape-mismatch", "RETRACE", a lint rule name, ...); ``where`` is a
    human location — ``block 0 op 3`` for program checks, ``path:line``
    for lint, the site name for retrace findings.  ``vars`` names the
    variables (or symbols) involved so tooling can link back into the
    program without re-parsing the message.
    """

    severity: Severity
    code: str
    message: str
    block_idx: Optional[int] = None
    op_idx: Optional[int] = None
    vars: Tuple[str, ...] = field(default=())

    @property
    def where(self) -> str:
        if self.block_idx is None:
            return ""
        if self.op_idx is None:
            return f"block {self.block_idx}"
        return f"block {self.block_idx} op {self.op_idx}"

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity} {self.code}{loc}: {self.message}"


def errors(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity is Severity.ERROR]


def format_report(diags: Sequence[Diagnostic], title: str = "") -> str:
    """Multi-line report, most severe first (stable within a severity)."""
    lines: List[str] = []
    if title:
        lines.append(title)
    for d in sorted(diags, key=lambda d: -int(d.severity)):
        lines.append(f"  {d}")
    if not diags:
        lines.append("  (no diagnostics)")
    return "\n".join(lines)
