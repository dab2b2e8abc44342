"""Shared by the fleet slice's parity tests: one serving drive written
once and run on both packages (JAX on the CPU, the port with
``device="cpu"``) on the same numpy weights and ``ManualClock`` traces,
and the isolation that keeps their registry text comparable.

- :func:`no_retrace_sites` empties the JAX package's process-global
  retrace auditor for a drive: its engine's ``healthz`` publishes the
  auditor's sites (``jit_calls_total{site=...}``) into the registry
  whenever it has any, and a JAX test run earlier in the same process
  with ``FLAGS.jit_audit`` on leaves some there.  The port has no
  auditor yet, so an exact exposition comparison needs the JAX drive to
  see none; ``mock.patch.dict`` restores them afterwards.
- :class:`Side` bundles one package's serving names with a uniform
  engine constructor, so a scenario is a function of a ``Side``.
- :func:`observe` reads a drained fleet's per-request ledger (by
  submission order: rids are process-wide counters in both packages),
  its ``snapshot()``, ``healthz()`` and ``metrics_text()``.
"""

import contextlib
from unittest import mock

import numpy as np

# the gates' model: vocab 64, one layer, two heads of 8
CFG = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
           max_positions=128)


@contextlib.contextmanager
def no_retrace_sites():
    from paddle_tpu.analysis.retrace import auditor

    with mock.patch.dict(auditor().sites, {}, clear=True):
        yield


class Side:
    """One package's serving surface: ``name`` is "jax" or "port"."""

    def __init__(self, name, params):
        self.name = name
        if name == "jax":
            import jax.numpy as jnp
            import paddle_tpu.analysis.concurrency.lifecycle as lifecycle
            import paddle_tpu.serving as serving
            import paddle_tpu.serving.control as control
            import paddle_tpu.serving.migrate as migrate

            self.model = serving.DecoderLM(**CFG)
            self._params = {k: jnp.asarray(v) for k, v in params.items()}
        else:
            import paddle_tpu_torch.analysis.concurrency.lifecycle as \
                lifecycle
            import paddle_tpu_torch.serving as serving
            import paddle_tpu_torch.serving.control as control
            import paddle_tpu_torch.serving.migrate as migrate
            from paddle_tpu_torch.convert import decoder_lm_from_numpy

            self.model = decoder_lm_from_numpy(
                params, serving.DecoderLM(**CFG, device="cpu"))
        self.serving, self.lifecycle = serving, lifecycle
        self.control, self.migrate = control, migrate
        for n in ("FleetRouter", "FleetFaultPlan", "FaultPlan",
                  "ManualClock", "ReplicaState", "TenantRegistry",
                  "AutoscalePolicy"):
            setattr(self, n, getattr(serving, n))

    def engine(self, **kw):
        """A ``ServingEngine`` on the side's model (the JAX one on its
        plain attention path, as on the CPU; the port's on the CPU)."""
        if self.name == "jax":
            return self.serving.ServingEngine(self.model, self._params,
                                              use_kernel=False, **kw)
        return self.serving.ServingEngine(self.model, device="cpu", **kw)

    def maker(self, **kw):
        """``make_engine(idx, time_fn)`` for a FleetRouter."""
        return lambda i, time_fn: self.engine(time_fn=time_fn, **kw)

    @contextlib.contextmanager
    def isolated(self):
        """The drive's scope: the lifecycle recorder reset, and on the
        JAX side the retrace auditor emptied."""
        self.lifecycle.reset_recorder()
        if self.name == "jax":
            with no_retrace_sites():
                yield
        else:
            yield


def run_both(weights, scenario):
    """``scenario(side)`` on both packages; returns {"jax": .., "port":
    ..}."""
    out = {}
    for name in ("jax", "port"):
        side = Side(name, weights)
        with side.isolated():
            out[name] = scenario(side)
            out[name]["transitions"] = {
                "|".join(k): v for k, v in
                side.lifecycle.recorder().counts().items()}
            out[name]["undeclared"] = \
                side.lifecycle.undeclared_transitions()
    return out


def observe(fl, frids, streams=None):
    """A drained fleet's ledger, by submission order."""
    out = {"status": [str(fl.status(f)) for f in frids],
           "results": [fl.result(f) for f in frids],
           "resubmits": [fl._requests[f].resubmits for f in frids],
           "snapshot": fl.snapshot(),
           "healthz": fl.healthz(),
           "metrics_text": fl.metrics_text(),
           "replica_states": [str(r.state) for r in fl.replicas],
           "dead_reasons": [r.dead_reason for r in fl.replicas]}
    if streams is not None:
        out["streams"] = [list(s) for s in streams]
    return out


def assert_same(got):
    """The two packages' observations equal, key by key (a failing key
    is named), with no undeclared lifecycle transition."""
    j, p = got["jax"], got["port"]
    assert set(j) == set(p)
    for key in j:
        assert p[key] == j[key], key
    assert p["undeclared"] == []


def prompts(rng, n, shared=0, lo=3, hi=9, vocab=64):
    """``n`` prompts, each ``shared`` common tokens then a random tail."""
    sysp = rng.randint(2, vocab, size=shared).tolist() if shared else []
    return [sysp + rng.randint(2, vocab, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def gate_params():
    """The gates' seed-0 weights (the JAX package's draw) as numpy."""
    from paddle_tpu_torch.serving._gate import gate_weights

    return gate_weights(CFG["max_positions"])


def normalized_events(events, keys=("rid", "frid", "erid")):
    """Trace events as dicts, each id renamed by first appearance (the
    packages count rids process-wide)."""
    seen = {}
    out = []
    for e in events:
        d = e.to_dict()
        args = d.get("args", {})
        for k in keys:
            if k in args:
                args[k] = seen.setdefault((k, args[k]), len(seen))
        if "id" in d:
            d["id"] = seen.setdefault(("id", d["id"]), len(seen))
        out.append(d)
    return out


def np_array(x):
    """A host array of a numpy array or a CPU tensor (bf16 widened to
    f32)."""
    import torch

    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, dtype=np.float32) if str(x.dtype) == "bfloat16" \
        else np.asarray(x)
