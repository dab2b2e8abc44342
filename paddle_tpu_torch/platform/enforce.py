"""Error machinery — the ``PADDLE_ENFORCE`` analog (a copy of
``paddle_tpu/platform/enforce.py``'s check helper and error type)."""

from __future__ import annotations


class EnforceError(RuntimeError):
    """Raised when a framework invariant or user-facing check fails."""

    def __init__(self, message: str, *, context: str | None = None):
        self.context = context
        if context:
            message = f"[{context}] {message}"
        super().__init__(message)


def enforce_that(cond: bool, message: str = "enforce failed", *,
                 context: str | None = None) -> None:
    if not cond:
        raise EnforceError(message, context=context)


def refuse_unported(where: str, context: str, **given) -> None:
    """Raise for an argument of a slice not ported yet (``given``: name ->
    (value passed, its no-op default, the slice))."""
    for name, (value, default, part) in given.items():
        enforce_that(value is default or value == default,
                     f"{where}({name}=...) is not ported yet: it comes with "
                     f"{part}", context=context)
