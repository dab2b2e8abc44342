"""``python -m paddle_tpu_torch.obs`` — export traces, replay the seeded
chaos scenario (the port of ``paddle_tpu/obs/cli.py``).

Subcommands:

- ``export <events.jsonl | postmortem.json> [-o out.json]`` — convert a
  raw event dump (``Tracer.save`` JSONL or a flight-recorder postmortem
  file) into Chrome-trace JSON.  Open the output at ``ui.perfetto.dev``
  (Open trace file) or ``chrome://tracing``.
- ``chaos [-o out.json] [--replicas N] [--seed S] [--device D]`` — run
  the seeded 4-replica kill + partition + slow chaos replay (the
  acceptance scenario) with tracing on and write its Chrome trace.
  Deterministic: two runs with the same seed write byte-identical traces.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from paddle_tpu_torch.platform.device import DeviceLike

__all__ = ["main", "seeded_chaos"]


def seeded_chaos(num_replicas: int = 4, seed: int = 0,
                 n_requests: int = 10, registry=None,
                 device: DeviceLike = None):
    """The acceptance chaos scenario on one injected clock, on ``device``
    (default ``cuda``): a shared 8-token prefix over ``n_requests``
    prompts, replica 0 killed at tick 8, replica 1 heartbeat-partitioned
    from tick 2 past the lease TTL (lease-expiry death + resubmit, the
    second death mode), replica 2 slowed to every other tick.  Returns
    ``(tracer, fleet, frids)`` after a full drain (conservation checked).

    The JAX package's replay with its seeded streams, at its widths
    (vocab 64, one layer, two heads of 8, page 4) with seed-0 numpy
    weights; lives here so the CLI and the tests replay the SAME
    trace."""
    import numpy as np

    from paddle_tpu_torch.obs.trace import Tracer
    from paddle_tpu_torch.serving._gate import gate_model
    from paddle_tpu_torch.serving.engine import ServingEngine
    from paddle_tpu_torch.serving.faults import FleetFaultPlan, ManualClock
    from paddle_tpu_torch.serving.fleet import FleetRouter

    model = gate_model(device, max_positions=128)
    clock = ManualClock(tick_s=0.01)
    plan = FleetFaultPlan(seed=seed, clock=clock, kill_at={8: 0},
                          slow_replicas={2: 2}, partitions={1: (2, 999)})
    tracer = Tracer(time_fn=clock, registry=registry)

    def mk(i, time_fn):
        return ServingEngine(model, eos_id=1, page_size=4, num_pages=32,
                             max_pages_per_seq=8, max_slots=4,
                             buckets=(8, 16), time_fn=time_fn,
                             device=device)

    fleet = FleetRouter(mk, num_replicas, heartbeat_s=0.04,
                        resubmit_budget=2, faults=plan, tracer=tracer)
    rng = np.random.RandomState(seed)
    system = rng.randint(2, 64, size=8).tolist()     # 2 full shared pages
    frids = [fleet.submit(system + rng.randint(2, 64, size=4).tolist(),
                          max_tokens=12) for _ in range(n_requests)]
    fleet.run(max_ticks=2000)
    return tracer, fleet, frids


def _parse(args: Sequence[str], flag: str,
           default: Optional[str] = None) -> Tuple[List[str], Optional[str]]:
    """Take ``flag value`` or ``flag=value`` out of ``args``: returns (the
    arguments left, the value or ``default``)."""
    args = list(args)
    for i, a in enumerate(args):
        if a.startswith(flag + "="):
            del args[i]
            return args, a[len(flag) + 1:]
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
        from paddle_tpu_torch.obs.export import save_chrome_trace

        args, out = _parse(args, "-o", "chaos_trace.json")
        args, replicas = _parse(args, "--replicas", "4")
        args, seed = _parse(args, "--seed", "0")
        args, device = _parse(args, "--device")
        tracer, fleet, frids = seeded_chaos(int(replicas), int(seed),
                                            device=device)
        save_chrome_trace(tracer.events, out)
        snap = fleet.snapshot()
        print(f"wrote {out} ({len(tracer.events)} events): "
              f"{snap['fleet_completed']}/{len(frids)} completed, "
              f"{snap['fleet_resubmits']} resubmits, "
              f"{snap['fleet_replicas_dead']} replicas dead")
        return 0
    print(f"unknown command {cmd!r}; see python -m paddle_tpu_torch.obs")
    return 2
