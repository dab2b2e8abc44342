"""Lock-discipline checker — the ``CONC-AUDIT`` rule family (the port of
``paddle_tpu/analysis/concurrency/guards.py``, pointed at the port's
modules).

The distributed runtime's host-side state lives in two concurrency
regimes, and both are now *declared* next to the field they protect:

- ``# guarded_by(<lock_attr>)`` — the field is shared across threads
  and every access outside ``__init__``/``__post_init__`` must be
  lexically inside a ``with <...>.<lock_attr>:`` block.  The proof is
  lexical on purpose: a ``with m._lock:`` over another object's lock of
  the same *name* satisfies the checker, which matches how this repo
  shares one lock between a parent metric and its series views.
- ``# guarded_by(serialized: <justification>)`` — the field is mutable
  but *confined*: a documented happens-before edge (``Thread.join`` in
  ``AsyncCheckpointer.wait``, the single-threaded fleet tick driving
  ``HostPageTier``, the owner thread driving the master server)
  serializes all accesses, so no lock exists.  The checker proves the
  field is touched only through ``self`` inside its declaring class —
  any cross-object access needs an explicit
  ``# lint: allow(guarded-by)`` naming the edge that makes it safe.
- ``# guarded_by(caller: <lock_attr>)`` on a ``def`` line — the
  Clang-``REQUIRES`` idiom: the method touches guarded fields but the
  *caller* holds the lock.  The body is checked as if the lock were
  held, and every ``self.<method>()`` call site outside a ``with`` over
  that lock (and outside ``__init__``) is a finding.

The annotation rides the assignment that *creates* the field (same
line or the line above), in ``__init__``/``__post_init__`` or the class
body.  Suppression uses the linter's own escape hatch —
``# lint: allow(guarded-by)`` on the access line or the line directly
above — so one grep (``lint: allow``) still finds every sanctioned
exception in the repo.

A second, coverage-shaped rule keeps the convention honest: every
module in :data:`REQUIRED_MODULES` (the ones that actually spawn
threads or hand state across them) must declare at least one guard —
a new threaded module cannot silently opt out of the discipline.

All findings carry the grep-able ``CONC-AUDIT`` code.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from paddle_tpu_torch.analysis.lint import _allowed_rules, _attr_chain

__all__ = ["run_guard_check", "check_guards_source", "collect_guards",
           "REQUIRED_MODULES", "GuardSpec"]

_GUARD_RE = re.compile(r"#\s*guarded_by\(([^)]*)\)")
_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_ALLOW_RULE = "guarded-by"

#: Modules (repo-relative POSIX paths) that are genuinely threaded —
#: they spawn threads, run under ThreadingTCPServer handlers, or hand
#: mutable state across a thread boundary — and therefore MUST declare
#: their discipline.  An entry with zero annotations is itself a
#: finding.  (The JAX package's list also names its jit retrace auditor,
#: which the port does not have.)
REQUIRED_MODULES: Tuple[str, ...] = (
    "paddle_tpu_torch/resilience/checkpointer.py",
    "paddle_tpu_torch/serving/kv_cache.py",
    "paddle_tpu_torch/obs/registry.py",
    "paddle_tpu_torch/obs/trace.py",
    "paddle_tpu_torch/platform/stats.py",
    "paddle_tpu_torch/master/service.py",
    "paddle_tpu_torch/master/server.py",
    "paddle_tpu_torch/reader/prefetch.py",
)

_INIT_METHODS = ("__init__", "__post_init__")


@dataclass(frozen=True)
class GuardSpec:
    """One declared guard: ``field`` in ``cls`` is protected by
    ``lock`` (kind ``"lock"``) or by a documented serialization edge
    (kind ``"serialized"``, justification in ``note``)."""

    cls: str
    field: str
    kind: str                  # "lock" | "serialized"
    lock: Optional[str]        # lock attribute name for kind "lock"
    note: str
    lineno: int


def _parse_guard_comment(lines: List[str], lineno: int) -> Optional[Tuple[str, Optional[str], str]]:
    """(kind, lock, note) for a guarded_by comment on ``lineno`` or the
    line directly above; None when absent or malformed (malformed is
    reported by the caller via the raw-text sweep)."""
    for ln in (lineno, lineno - 1):
        if not 1 <= ln <= len(lines):
            continue
        m = _GUARD_RE.search(lines[ln - 1])
        if not m:
            continue
        body = m.group(1).strip()
        if body.startswith("serialized"):
            _, _, note = body.partition(":")
            return ("serialized", None, note.strip())
        if body.startswith("caller"):
            _, _, lock = body.partition(":")
            lock = lock.strip()
            if _IDENT_RE.match(lock):
                return ("caller", lock, "")
            return ("malformed", None, body)
        if _IDENT_RE.match(body):
            return ("lock", body, "")
        return ("malformed", None, body)
    return None


def collect_guards(tree: ast.Module, lines: List[str]) -> Dict[str, List[GuardSpec]]:
    """{class name: [GuardSpec, ...]} for every annotated field-creating
    assignment (class body, or ``self.x = ...`` in __init__/__post_init__)."""
    out: Dict[str, List[GuardSpec]] = {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        specs: List[GuardSpec] = []

        def _try(field: str, lineno: int) -> None:
            parsed = _parse_guard_comment(lines, lineno)
            if parsed is None:
                return
            kind, lock, note = parsed
            specs.append(GuardSpec(cls.name, field, kind, lock, note,
                                   lineno))

        for node in cls.body:
            if isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                _try(node.target.id, node.lineno)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        _try(t.id, node.lineno)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a guarded_by(caller: L) on the def line declares the
                # REQUIRES contract for the whole method
                _try(node.name, node.lineno)
                if node.name in _INIT_METHODS:
                    for sub in ast.walk(node):
                        targets: List[ast.expr] = []
                        if isinstance(sub, ast.Assign):
                            targets = list(sub.targets)
                        elif isinstance(sub, ast.AnnAssign):
                            targets = [sub.target]
                        for t in targets:
                            if isinstance(t, ast.Attribute) and \
                                    isinstance(t.value, ast.Name) and \
                                    t.value.id == "self":
                                _try(t.attr, sub.lineno)
        if specs:
            out[cls.name] = specs
    return out


class _AccessVisitor(ast.NodeVisitor):
    """Walk one class's methods tracking which lock *names* are
    lexically held (``with <chain ending in name>:``), and record every
    access to a guarded field."""

    def __init__(self, cls: ast.ClassDef,
                 own: Dict[str, GuardSpec],
                 module_guards: Dict[str, List[GuardSpec]],
                 caller_locks: Dict[str, str]):
        self.cls = cls
        self.own = own                      # this class's field -> spec
        self.module_guards = module_guards  # field -> specs, whole module
        self.caller_locks = caller_locks    # method -> lock it REQUIRES
        self.held: List[str] = []           # stack of held lock names
        self.in_init = 0
        self.findings: List[Tuple[int, str]] = []

    # -- scope tracking ----------------------------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        is_init = node.name in _INIT_METHODS
        if is_init:
            self.in_init += 1
        req = self.caller_locks.get(node.name)
        if req is not None:
            self.held.append(req)   # the declared REQUIRES contract
        self.generic_visit(node)
        if req is not None:
            self.held.pop()
        if is_init:
            self.in_init -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and f.value.id == "self":
            req = self.caller_locks.get(f.attr)
            if req is not None and req not in self.held and \
                    not self.in_init:
                self.findings.append((
                    node.lineno,
                    f"call to {self.cls.name}.{f.attr}() — declared "
                    f"guarded_by(caller: {req}) — outside "
                    f"`with ...{req}:`"))
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            chain = _attr_chain(item.context_expr)
            if len(chain) >= 2:
                acquired.append(chain[-1])
        self.held.extend(acquired)
        self.generic_visit(node)
        del self.held[len(self.held) - len(acquired):]

    # -- the check ---------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        recv = node.value
        field = node.attr
        if isinstance(recv, ast.Name) and recv.id == "self":
            spec = self.own.get(field)
            if spec is not None and not self.in_init:
                if spec.kind == "lock" and spec.lock not in self.held:
                    self.findings.append((
                        node.lineno,
                        f"{self.cls.name}.{field} is "
                        f"guarded_by({spec.lock}) but accessed outside "
                        f"`with ...{spec.lock}:`"))
                # serialized: any self access inside the class is the
                # declared discipline — nothing to prove here
        else:
            # cross-object access to a field name guarded anywhere in
            # this module: x._pending, series.value, ...
            specs = self.module_guards.get(field, ())
            for spec in specs:
                if spec.kind == "lock":
                    if spec.lock not in self.held:
                        self.findings.append((
                            node.lineno,
                            f"access to '{field}' (guarded_by"
                            f"({spec.lock}) in {spec.cls}) outside "
                            f"`with ...{spec.lock}:`"))
                    break
                self.findings.append((
                    node.lineno,
                    f"cross-object access to '{field}' — declared "
                    f"guarded_by(serialized) in {spec.cls}; name the "
                    "happens-before edge with `# lint: "
                    "allow(guarded-by)` if this is safe"))
                break
        self.generic_visit(node)


def check_guards_source(src: str, path: str = "<string>") -> Tuple[List[Diagnostic], int]:
    """(findings, number of guard annotations) for one source file."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return ([Diagnostic(Severity.ERROR, "CONC-AUDIT",
                            f"{path}:{e.lineno}: parse error: {e.msg}")],
                0)
    lines = src.splitlines()
    per_class = collect_guards(tree, lines)
    n_guards = 0
    diags: List[Diagnostic] = []
    field_index: Dict[str, List[GuardSpec]] = {}
    for specs in per_class.values():
        for s in specs:
            if s.kind == "malformed":
                diags.append(Diagnostic(
                    Severity.ERROR, "CONC-AUDIT",
                    f"{path}:{s.lineno}: malformed guarded_by({s.note}) "
                    "— use guarded_by(<lock_attr>) or "
                    "guarded_by(serialized: <justification>)",
                    vars=(f"{path}:{s.lineno}",)))
                continue
            n_guards += 1
            if s.kind == "serialized" and not s.note:
                diags.append(Diagnostic(
                    Severity.ERROR, "CONC-AUDIT",
                    f"{path}:{s.lineno}: guarded_by(serialized:) on "
                    f"{s.cls}.{s.field} needs a justification naming "
                    "the happens-before edge",
                    vars=(f"{path}:{s.lineno}",)))
            if s.kind != "caller":
                field_index.setdefault(s.field, []).append(s)
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        own = {s.field: s for s in per_class.get(cls.name, [])
               if s.kind in ("lock", "serialized")}
        caller_locks = {s.field: s.lock
                        for s in per_class.get(cls.name, [])
                        if s.kind == "caller"}
        v = _AccessVisitor(cls, own, field_index, caller_locks)
        for node in cls.body:
            v.visit(node)
        for lineno, msg in v.findings:
            if _ALLOW_RULE in _allowed_rules(lines, lineno):
                continue
            diags.append(Diagnostic(
                Severity.ERROR, "CONC-AUDIT", f"{path}:{lineno}: {msg}",
                vars=(f"{path}:{lineno}",)))
    return diags, n_guards


def _package_root() -> Path:
    return Path(__file__).resolve().parent.parent.parent


def run_guard_check(paths: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    """Check every annotated module in the package (default) or just
    ``paths``; enforce annotation coverage over :data:`REQUIRED_MODULES`
    when running package-wide."""
    pkg = _package_root()
    check_coverage = paths is None
    if paths is None:
        files = sorted(pkg.rglob("*.py"))
    else:
        files = [Path(p) for p in paths]
    out: List[Diagnostic] = []
    annotated: Set[str] = set()
    for f in files:
        src = f.read_text()
        if "guarded_by(" not in src:
            continue
        try:
            rel = f.resolve().relative_to(pkg.parent).as_posix()
        except ValueError:
            rel = f.as_posix()
        diags, n = check_guards_source(src, path=rel)
        out.extend(diags)
        if n:
            annotated.add(rel)
    if check_coverage:
        for mod in REQUIRED_MODULES:
            if mod not in annotated:
                out.append(Diagnostic(
                    Severity.ERROR, "CONC-AUDIT",
                    f"{mod}: threaded module declares no guarded_by "
                    "annotations — declare the lock (or the serializing "
                    "happens-before edge) for its shared state",
                    vars=(mod,)))
    out.sort(key=lambda d: d.message)
    return out
