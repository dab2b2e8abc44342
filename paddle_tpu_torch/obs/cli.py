"""``python -m paddle_tpu_torch.obs`` — export traces (the port of
``paddle_tpu/obs/cli.py``).

Subcommands:

- ``export <events.jsonl | postmortem.json> [-o out.json]`` — convert a
  raw event dump (``Tracer.save`` JSONL or a flight-recorder postmortem
  file) into Chrome-trace JSON.  Open the output at ``ui.perfetto.dev``
  (Open trace file) or ``chrome://tracing``.
- ``chaos`` — the seeded multi-replica chaos replay needs the fleet
  router and its fault plan, which come with the fleet slice (A10b);
  it exits 2 naming that slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from paddle_tpu_torch.platform.enforce import EnforceError

__all__ = ["main", "seeded_chaos"]

_CHAOS_MISSING = ("the seeded chaos replay needs FleetRouter and "
                  "FleetFaultPlan, which come with the fleet slice (A10b) "
                  "of the port")


def seeded_chaos(num_replicas: int = 4, seed: int = 0,
                 n_requests: int = 10, registry=None):
    """The acceptance chaos scenario of the JAX package (a seeded
    kill + partition + slow replay over a fleet of engines).  Raises
    until the fleet slice (A10b) brings ``FleetRouter``."""
    raise EnforceError(_CHAOS_MISSING, context="obs")


def _parse(args: Sequence[str], flag: str,
           default: Optional[str] = None) -> Tuple[List[str], Optional[str]]:
    args = list(args)
    if flag in args:
        i = args.index(flag)
        if i + 1 >= len(args):      # trailing flag with no value
            del args[i]
            return args, default
        val = args[i + 1]
        del args[i:i + 2]
        return args, val
    return args, default


def main(argv: Optional[Sequence[str]] = None) -> int:
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(__doc__)
        return 2
    cmd, args = args[0], args[1:]
    if cmd == "export":
        from paddle_tpu_torch.obs.export import load_events, \
            save_chrome_trace

        args, out = _parse(args, "-o")
        if not args:
            print("usage: python -m paddle_tpu_torch.obs export "
                  "<events-file> [-o out.json]")
            return 2
        src = args[0]
        out = out or (src.rsplit(".", 1)[0] + ".chrome.json")
        events = load_events(src)
        save_chrome_trace(events, out)
        print(f"wrote {out} ({len(events)} events) — open in "
              "ui.perfetto.dev or chrome://tracing")
        return 0
    if cmd == "chaos":
        print(f"chaos: {_CHAOS_MISSING}")
        return 2
    print(f"unknown command {cmd!r}; see python -m paddle_tpu_torch.obs")
    return 2
