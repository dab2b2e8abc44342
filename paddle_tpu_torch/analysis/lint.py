"""Repo-invariant linter (the port of ``paddle_tpu/analysis/lint.py``):
AST rules for the mistakes this codebase has actually had to engineer
away.

Every rule encodes a repo contract that tests cannot easily enforce:

- ``wall-clock``       — ``time.time()`` / ``time.monotonic()`` /
  ``time.perf_counter()`` called in serving/, master/, obs/ or
  resilience/ code.
  Those layers run on an injectable clock (``time_fn=`` / ``FaultPlan``
  ``ManualClock``) so SLO, fault AND tracing paths are testable without
  sleeps — the obs tracer stamping events off the injected clock is
  what makes chaos-trace exports byte-deterministic.  Passing
  ``time.monotonic`` as an injectable *default* is fine — only calls
  are flagged.
- ``unseeded-random``  — module-function ``np.random.*`` calls (the
  process-global RNG) in library code; use ``np.random.RandomState(seed)``
  so parity tests and multi-host runs stay deterministic.
- ``host-sync``        — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``np.asarray``/``np.array`` (and the JAX package's ``jnp.asarray``/
  ``jax.device_get``) calls — and ``float()``/``int()`` over a tensor
  expression (``torch.*``, or ``jnp``/``jax``) — lexically inside a
  ``for``/``while`` loop in serving, obs, platform or resilience code: a
  per-tick loop that syncs per element serializes the device pipeline
  (one sync per *tick* is the engine's documented budget, and
  instrumentation must add ZERO to it — obs is covered so a tracer hook
  can never smuggle a readback into the tick).  ``torch.cuda.
  synchronize()``, a stream's or event's ``.synchronize()`` and
  ``block_until_ready`` are flagged at ANY depth, loop or not: they stall
  on the WHOLE pipeline, so the only sanctioned uses are deliberate
  end-of-window timing syncs (``platform/stats.py``'s
  ``timer(block=...)``), each carrying a justified
  ``# lint: allow(host-sync)``.
- ``mutable-default``  — mutable default argument values (list/dict/set
  literals or constructors), the classic shared-state trap.
- ``import-time-flags``— reading ``FLAGS.<name>`` at module import time
  (module body, class body, or a function's *default argument*): the
  value freezes before ``paddle.init(**kwargs)`` / tests can override
  it.  ``FLAGS.define(...)`` and friends are the registry, not reads.

Findings are :class:`Diagnostic`\\ s with ``block_idx=None`` and the
location carried in the message (``path:line``).  Any rule is
suppressible per line with an inline ``# lint: allow(<rule>[, <rule>])``
comment on the offending line or the line directly above it.

Run: ``python -m paddle_tpu_torch.analysis lint [paths...]`` (defaults to
the ``paddle_tpu_torch`` package).  A nonzero finding count prints a
final line tagged ``LINT-FAIL`` and exits 1, the same loud-failure
contract as PAGE-LEAK/REF-LEAK.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity

__all__ = ["run_lint", "lint_file", "lint_source", "RULES"]

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([^)]*)\)")

_CLOCK_CALLS = {"time", "monotonic", "perf_counter", "monotonic_ns",
                "time_ns", "clock"}
_SEEDED_RANDOM_OK = {"RandomState", "default_rng", "Generator",
                     "SeedSequence", "PCG64", "Philox", "bit_generator"}
_SYNC_FUNCS = {("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
               ("numpy", "array"), ("jnp", "asarray"),
               ("jax", "device_get")}
# tensor methods that read the device's value back to the host
_SYNC_METHODS = {"item", "tolist", "cpu"}
# a name chain starting with one of these is a device expression
_DEVICE_ROOTS = ("torch", "jnp", "jax")
_FLAGS_REGISTRY_ATTRS = {"define", "set", "update", "to_dict"}


@dataclass(frozen=True)
class Rule:
    name: str
    description: str
    # path predicate over POSIX-ish relative parts ("serving" in parts)
    applies: Callable[[Sequence[str]], bool]
    check: Callable[[ast.AST, List[str]], List]   # -> [(line, message)]


def _attr_chain(node: ast.AST) -> List[str]:
    """x.y.z -> ["x", "y", "z"]; empty when not a plain name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _contains_device_expr(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        chain = _attr_chain(sub) if isinstance(sub, ast.Attribute) else []
        if chain and chain[0] in _DEVICE_ROOTS:
            return True
    return False


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _check_wall_clock(tree, lines):
    # resolve aliases first so `import time as t` / `from time import
    # monotonic` cannot smuggle a wall-clock call past the rule
    module_aliases = {"time"}            # names bound to the time module
    func_aliases: dict = {}              # local name -> clock fn name
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    module_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in _CLOCK_CALLS:
                    func_aliases[a.asname or a.name] = a.name
    out = []

    def flag(node, spelled):
        out.append((node.lineno,
                    f"{spelled} in serving/master code — route through "
                    "the injectable clock (time_fn= / FaultPlan "
                    "ManualClock)"))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if len(chain) == 2 and chain[0] in module_aliases \
                and chain[1] in _CLOCK_CALLS:
            flag(node, f"{chain[0]}.{chain[1]}()")
        elif isinstance(node.func, ast.Name) \
                and node.func.id in func_aliases:
            flag(node, f"{node.func.id}() (= time."
                       f"{func_aliases[node.func.id]})")
    return out


def _check_unseeded_random(tree, lines):
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if len(chain) == 3 and chain[0] in ("np", "numpy") \
                and chain[1] == "random" \
                and chain[2] not in _SEEDED_RANDOM_OK:
            out.append((node.lineno,
                        f"np.random.{chain[2]}() uses the process-global "
                        "RNG — use np.random.RandomState(seed) so runs "
                        "replay deterministically"))
    return out


class _LoopSyncVisitor(ast.NodeVisitor):
    """Collect host-sync calls lexically inside for/while bodies."""

    def __init__(self):
        self.loop_depth = 0
        self.findings: List = []

    def _visit_loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop

    def visit_Call(self, node: ast.Call):
        # whole-pipeline syncs are flagged at ANY depth (not just loops):
        # they drain every queued kernel, which serving/obs/platform
        # layers may only do as a deliberate, annotated end-of-timing-
        # window sync.  Covers torch.cuda.synchronize(), a stream's or an
        # event's .synchronize(), and both forms of block_until_ready.
        chain = _attr_chain(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if attr in ("block_until_ready", "synchronize") \
                or (len(chain) == 2 and chain[0] == "jax"
                    and chain[1] == "block_until_ready"):
            self.findings.append(
                (node.lineno, f"{attr or chain[-1]}() stalls on the whole "
                 "device pipeline — sync at most once per window, and "
                 "annotate a deliberate timing sync with "
                 "`# lint: allow(host-sync)`"))
        if self.loop_depth > 0:
            if attr in _SYNC_METHODS:
                self.findings.append(
                    (node.lineno, f".{attr}() inside a per-tick serving "
                     "loop forces one device sync per element — batch "
                     "the readback outside the loop"))
            chain = tuple(chain)
            if chain in _SYNC_FUNCS:
                self.findings.append(
                    (node.lineno, f"{'.'.join(chain)}() inside a "
                     "per-tick serving loop syncs the device per "
                     "element — hoist one readback out of the loop"))
            if isinstance(node.func, ast.Name) \
                    and node.func.id in ("float", "int") and node.args \
                    and _contains_device_expr(node.args[0]):
                self.findings.append(
                    (node.lineno, f"{node.func.id}() over a tensor "
                     "expression inside a loop blocks on the device "
                     "each iteration — stack and read back once"))
        self.generic_visit(node)


def _check_host_sync(tree, lines):
    v = _LoopSyncVisitor()
    v.visit(tree)
    return v.findings


def _check_mutable_default(tree, lines):
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        a = node.args
        for default in list(a.defaults) + [d for d in a.kw_defaults if d]:
            bad = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set", "bytearray"))
            if bad:
                name = getattr(node, "name", "<lambda>")
                out.append((default.lineno,
                            f"mutable default argument in {name}() is "
                            "shared across calls — default to None and "
                            "construct inside"))
    return out


def _check_import_time_flags(tree, lines):
    out = []

    def flags_reads(node) -> Iterable[ast.Attribute]:
        """FLAGS reads in code that executes AT IMPORT TIME.  The walk
        stops at function/lambda boundaries (their bodies run later —
        even when the def sits inside a module-level if/try/with) but
        still visits their defaults and decorators, which do evaluate
        at import; class bodies execute at import and are descended."""
        stack = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                stack.extend(d for d in sub.args.defaults if d)
                stack.extend(d for d in sub.args.kw_defaults if d)
                stack.extend(getattr(sub, "decorator_list", []))
                continue
            if isinstance(sub, ast.Attribute) \
                    and isinstance(sub.value, ast.Name) \
                    and sub.value.id == "FLAGS" \
                    and sub.attr not in _FLAGS_REGISTRY_ATTRS:
                yield sub
            stack.extend(ast.iter_child_nodes(sub))

    for a in flags_reads(tree):
        out.append((a.lineno,
                    f"FLAGS.{a.attr} read at module import time freezes "
                    "the value before paddle.init()/env overrides apply "
                    "— read it inside the function that needs it"))
    return out


def _in_dirs(*names):
    return lambda parts: any(n in parts for n in names)


RULES: Dict[str, Rule] = {
    "wall-clock": Rule(
        "wall-clock",
        "direct clock calls in serving/master/obs/resilience code "
        "(injectable-clock layers)",
        _in_dirs("serving", "master", "obs", "resilience"),
        _check_wall_clock),
    "unseeded-random": Rule(
        "unseeded-random",
        "process-global np.random use in library code",
        lambda parts: True, _check_unseeded_random),
    "host-sync": Rule(
        "host-sync",
        "per-element device syncs inside serving/obs/platform/"
        "resilience loops (+ whole-pipeline syncs anywhere in those "
        "layers)",
        _in_dirs("serving", "obs", "platform", "resilience"),
        _check_host_sync),
    "mutable-default": Rule(
        "mutable-default", "mutable default argument values",
        lambda parts: True, _check_mutable_default),
    "import-time-flags": Rule(
        "import-time-flags", "FLAGS reads at module import time",
        lambda parts: "flags.py" not in parts[-1:],
        _check_import_time_flags),
}


# ---------------------------------------------------------------------------
# running the rules
# ---------------------------------------------------------------------------


def _allowed_rules(lines: List[str], lineno: int) -> set:
    """Rules allowlisted for ``lineno`` (1-based): an inline
    ``# lint: allow(...)`` on the line or the line directly above."""
    allowed = set()
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m:
                allowed.update(t.strip() for t in m.group(1).split(","))
    return allowed


def lint_source(src: str, path: str = "<string>",
                rules: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    """Lint one source string as if it lived at ``path`` (the path's
    directory parts select which rules apply)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Diagnostic(Severity.ERROR, "parse-error",
                           f"{path}:{e.lineno}: {e.msg}")]
    lines = src.splitlines()
    # scope from the RESOLVED path: a bare filename linted from inside
    # its directory (`cd serving && lint engine.py`) must still select
    # the dir-scoped rules, not silently skip them
    parts = tuple(Path(path).resolve().parts) if path != "<string>" \
        else ("<string>",)
    out: List[Diagnostic] = []
    for name, r in RULES.items():
        if rules is not None and name not in rules:
            continue
        if not r.applies(parts):
            continue
        for lineno, message in r.check(tree, lines):
            if name in _allowed_rules(lines, lineno):
                continue
            out.append(Diagnostic(
                Severity.ERROR, name, f"{path}:{lineno}: {message}",
                vars=(f"{path}:{lineno}",)))
    out.sort(key=lambda d: d.message)
    return out


def lint_file(path, root: Optional[Path] = None,
              rules: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    p = Path(path)
    rel = p.relative_to(root) if root is not None and p.is_absolute() \
        else p
    return lint_source(p.read_text(), path=str(rel), rules=rules)


def iter_python_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            files.extend(sorted(pp.rglob("*.py")))
        else:
            files.append(pp)
    return files


def run_lint(paths: Optional[Sequence[str]] = None,
             rules: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    """Lint ``paths`` (default: the ``paddle_tpu_torch`` package tree).
    Returns all findings; empty means clean."""
    if paths is None:
        pkg_root = Path(__file__).resolve().parent.parent
        paths = [str(pkg_root)]
        root: Optional[Path] = pkg_root.parent
    else:
        root = None
    out: List[Diagnostic] = []
    for f in iter_python_files(paths):
        out.extend(lint_file(f, root=root, rules=rules))
    return out
