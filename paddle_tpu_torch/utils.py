"""User utilities: config dump, model diagram, gradient check, network
comparison, parameter text files and torch weight import (the port of
``paddle_tpu/utils.py``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.topology import Topology

__all__ = ["compare_topologies", "dump_config", "extract_embedding",
           "gradient_check", "make_model_diagram", "param_to_text",
           "text_to_param", "topology_to_config", "torch2paddle"]


def topology_to_config(topology: Topology) -> Dict:
    """Serialize a Topology to a JSON-able dict (the ModelConfig analog):
    the layer graph, sizes and parameter shapes."""
    layers: List[Dict] = []
    name_to_param = {}
    for node in topology.nodes:
        entry = {
            "name": node.name,
            "type": node.layer_type,
            "size": node.size,
            "inputs": [i.name for i in node.inputs],
            "is_sequence": bool(node.is_sequence),
        }
        if getattr(node, "img_shape", None):
            entry["img_shape"] = list(node.img_shape)
        if node.params:
            entry["params"] = {}
            for pname, spec in node.params.items():
                full = spec.attr.name or f"{node.name}.{pname}"
                entry["params"][pname] = {"name": full,
                                          "shape": list(spec.shape)}
                name_to_param[full] = list(spec.shape)
        layers.append(entry)
    return {
        # the JAX package's format tag: a dump of the same topology is
        # the same document in both packages
        "format": "paddle_tpu_model_config_v1",
        "layers": layers,
        "parameters": [{"name": k, "shape": v}
                       for k, v in sorted(name_to_param.items())],
        "input_layers": [n.name for n in topology.data_nodes],
        "output_layers": [n.name for n in topology.outputs],
    }


def dump_config(topology: Topology, indent: int = 2) -> str:
    """The config dump as JSON text."""
    return json.dumps(topology_to_config(topology), indent=indent)


def make_model_diagram(topology: Topology,
                       graph_name: str = "model") -> str:
    """Graphviz dot text of the layer graph."""
    cfg = topology_to_config(topology)
    lines = [f"digraph {graph_name} {{", "  rankdir=TB;"]
    for lay in cfg["layers"]:
        shape = "box"
        if lay["type"] == "data":
            shape = "oval"
        elif lay["name"] in cfg["output_layers"]:
            shape = "doubleoctagon"
        label = f"{lay['name']}\\n{lay['type']}"
        if lay["size"]:
            label += f" [{lay['size']}]"
        lines.append(f'  "{lay["name"]}" [shape={shape}, label="{label}"];')
    for lay in cfg["layers"]:
        for src in lay["inputs"]:
            lines.append(f'  "{src}" -> "{lay["name"]}";')
    lines.append("}")
    return "\n".join(lines)


def _to_cpu64(value):
    """A feed on the CPU, floating arrays in float64."""
    t = torch.as_tensor(value)
    return t.double() if t.is_floating_point() else t


def gradient_check(cost, parameters, feeds, *, sample_entries: int = 8,
                   eps: float = 1e-3, seed: int = 0,
                   rtol: float = 2e-2) -> Dict[str, float]:
    """Numeric-vs-analytic gradient check over a whole topology.

    Runs on the CPU with the parameters and the floating feeds in
    float64 (layers that compute in f32 round there).  For each
    parameter, ``sample_entries`` random entries are perturbed (central
    differences) and compared with ``torch.autograd.grad`` of the
    reduced cost.  Returns {param_name: max relative error} and raises
    EnforceError when any exceeds ``rtol``."""
    from paddle_tpu_torch.platform.flags import FLAGS
    from paddle_tpu_torch.trainer import _reduce_cost  # avoids a cycle

    old_bf16 = FLAGS.use_bf16
    FLAGS.use_bf16 = False  # central differences drown in bf16 loss noise
    try:
        topo = Topology([cost])
        specs = topo.param_specs()
        src = parameters.as_dict() if hasattr(parameters, "as_dict") \
            else dict(parameters)
        pdict = {k: torch.as_tensor(v).detach().cpu().double()
                 for k, v in src.items() if k in specs}
        feeds = {k: _to_cpu64(v) for k, v in feeds.items()}
        state = topo.init_state("cpu")

        def loss_fn(p):
            outs = topo.forward(p, feeds, train=False, state=state)
            return _reduce_cost(outs[0])

        names = list(pdict)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in pdict.items()}
        grads = torch.autograd.grad(loss_fn(leaves),
                                    [leaves[k] for k in names],
                                    allow_unused=True)
        analytic = {k: (torch.zeros_like(pdict[k]) if g is None else g)
                    for k, g in zip(names, grads)}
        rng = np.random.RandomState(seed)
        report: Dict[str, float] = {}

        @torch.no_grad()
        def loss_at(name, i, delta):
            flat = pdict[name].clone().reshape(-1)
            flat[i] += delta
            return float(loss_fn({**pdict,
                                  name: flat.reshape(pdict[name].shape)}))

        for name, val in pdict.items():
            n = int(val.numel())
            idxs = rng.choice(n, size=min(sample_entries, n), replace=False)
            ana_flat = analytic[name].reshape(-1).numpy()
            worst = 0.0
            for i in idxs:
                ana = float(ana_flat[i])

                def rel_err(e):
                    num = (loss_at(name, i, +e)
                           - loss_at(name, i, -e)) / (2 * e)
                    return abs(num - ana) / max(abs(num), abs(ana), 1e-4)

                err = rel_err(eps)
                if err > rtol:
                    # a kink (relu/abs) inside +-eps or too little loss
                    # resolution fail a CORRECT gradient: retry a smaller
                    # and a larger eps; a wrong gradient fails at every eps
                    err = min(err, rel_err(eps / 8), rel_err(eps * 8))
                worst = max(worst, err)
            report[name] = worst
        bad = {k: v for k, v in report.items() if v > rtol}
        enforce_that(not bad, "gradient check failed: " + ", ".join(
            f"{k}: rel err {v:.4g} > {rtol}" for k, v in sorted(bad.items())),
            context="gradient_check")
        return report
    finally:
        FLAGS.use_bf16 = old_bf16


def compare_topologies(node_a, node_b, feeds_a, feeds_b=None, *,
                       seed: int = 0,
                       param_link: Optional[Dict[str, str]] = None,
                       check_inputs: tuple = (), rtol: float = 1e-4,
                       atol: float = 1e-5, flags_a: Optional[Dict] = None,
                       flags_b: Optional[Dict] = None, device=None):
    """Assert two differently-expressed topologies compute the SAME
    function: identical outputs AND identical gradients on the same data.

    Parameters are LINKED BY NAME: each topology is initialized with the
    same seed, then every parameter name they share (plus ``param_link``
    entries mapping b-name -> a-name) is copied from A into B.
    Gradients of the reduced first output are compared for every linked
    parameter and for each feed in ``check_inputs`` (identical dense
    arrays in both feed dicts).  ``flags_a``/``flags_b`` override FLAGS
    around each side (e.g. ``flags_b={"use_pallas": False}`` compares
    the fused recurrent kernels with their plain cells).  Returns
    ``(out_a, out_b, grads_a, grads_b)`` on the host."""
    from paddle_tpu_torch.platform.device import resolve_device
    from paddle_tpu_torch.platform.flags import FLAGS
    from paddle_tpu_torch.sequence import SequenceBatch
    from paddle_tpu_torch.trainer import _reduce_cost

    dev = resolve_device(device)
    feeds_b = feeds_a if feeds_b is None else feeds_b
    param_link = dict(param_link or {})

    old_bf16 = FLAGS.use_bf16
    FLAGS.use_bf16 = False  # bit-compare needs one rounding behavior
    try:
        topo_a, topo_b = Topology([node_a]), Topology([node_b])
        pa = Parameters.from_topology(topo_a, seed=seed,
                                      device=dev).as_dict()
        pb = Parameters.from_topology(topo_b, seed=seed,
                                      device=dev).as_dict()
        for nb in sorted(set(pa) & set(pb)):
            param_link.setdefault(nb, nb)
        enforce_that(bool(param_link) or bool(check_inputs),
                     "nothing to compare gradients through — link weights "
                     "via ParamAttr names or pass check_inputs",
                     context="compare")
        for nb, na in param_link.items():
            enforce_that(tuple(pa[na].shape) == tuple(pb[nb].shape),
                         f"linked param shape mismatch {na}~{nb}",
                         context="compare")
            pb[nb] = pa[na].clone()

        def run(topo, params, feeds, overrides):
            olds = {k: getattr(FLAGS, k) for k in (overrides or {})}
            for k, v in (overrides or {}).items():
                setattr(FLAGS, k, v)
            try:
                leaves = {k: v.detach().clone().requires_grad_(True)
                          for k, v in params.items()}
                f = dict(feeds)
                ins = {}
                for n in check_inputs:
                    ins[n] = torch.as_tensor(
                        np.asarray(feeds[n], np.float32),
                        device=dev).requires_grad_(True)
                    f[n] = ins[n]
                outs = topo.forward(leaves, f, train=False,
                                    state=topo.init_state(dev))
                o = outs[0]
                loss = _reduce_cost(o)
                wrt = list(leaves.values()) + list(ins.values())
                grads = torch.autograd.grad(loss, wrt, allow_unused=True)
                gp = dict(zip(leaves, grads[:len(leaves)]))
                gi = dict(zip(ins, grads[len(leaves):]))
                out = o.data if isinstance(o, SequenceBatch) else o
            finally:
                for k, v in olds.items():
                    setattr(FLAGS, k, v)

            def host(t):
                return None if t is None else t.detach().float().cpu() \
                    .numpy()

            return host(out), {k: host(g) for k, g in gp.items()}, \
                {k: host(g) for k, g in gi.items()}

        out_a, gpa, gia = run(topo_a, pa, feeds_a, flags_a)
        out_b, gpb, gib = run(topo_b, pb, feeds_b, flags_b)
        # image layers may emit [B,H,W,C] where an equivalent path emits
        # the flat [B,H*W*C]; compare per-example rows
        np.testing.assert_allclose(out_a.reshape(out_a.shape[0], -1),
                                   out_b.reshape(out_b.shape[0], -1),
                                   rtol=rtol, atol=atol,
                                   err_msg="outputs differ")
        for nb, na in sorted(param_link.items()):
            np.testing.assert_allclose(
                gpa[na], gpb[nb], rtol=rtol, atol=atol,
                err_msg=f"grad differs for linked param {na}~{nb}")
        for n in check_inputs:
            np.testing.assert_allclose(
                gia[n], gib[n], rtol=rtol, atol=atol,
                err_msg=f"grad differs for input {n}")
        return out_a, out_b, gpa, gpb
    finally:
        FLAGS.use_bf16 = old_bf16


def param_to_text(value, path: str) -> None:
    """Dump one parameter as the embedding-model text format: a header
    line ``version,floatSize,paraCount`` then comma-joined rows."""
    if torch.is_tensor(value):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value, dtype=np.float32)
    rows = arr.reshape(-1, arr.shape[-1]) if arr.ndim > 1 \
        else arr.reshape(1, -1)
    with open(path, "w") as f:
        f.write(f"0,4,{arr.size}\n")
        for row in rows:
            f.write(",".join(f"{x:.7f}" for x in row) + "\n")


def text_to_param(path: str, dim: Optional[int] = None) -> np.ndarray:
    """Load a text-format parameter file.  Returns [rows, dim] float32
    (or flat when the rows carry no consistent width)."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        count = int(header[2])
        rows = [np.array(line.strip().split(","), dtype=np.float32)
                for line in f if line.strip()]
    flat = np.concatenate(rows) if rows else np.zeros(0, np.float32)
    if flat.size != count:
        raise ValueError(f"{path}: header says {count} values, got "
                         f"{flat.size}")
    if dim:
        return flat.reshape(-1, dim)
    widths = {r.size for r in rows}
    return flat.reshape(len(rows), rows[0].size) if len(widths) == 1 \
        else flat


def extract_embedding(parameters: Parameters, name: str,
                      word_ids) -> np.ndarray:
    """Rows of a trained embedding table for a word subset, on the
    host."""
    table = parameters.get(name)
    return table[np.asarray(list(word_ids), dtype=np.int64)]


def torch2paddle(state_dict, parameters: Parameters,
                 name_map: Optional[Dict[str, str]] = None,
                 transpose_linear: bool = True) -> List[str]:
    """Import a torch ``state_dict`` into ``parameters``.

    Matching is by ``name_map`` (torch name -> our param name) when
    given, else by identical name, else by unique shape.  torch Linear
    weights are [out, in]; ours are [in, out] (``transpose_linear``).
    Each imported value lands on its parameter's device and dtype.
    Returns the list of imported parameter names."""
    ours = {k: v for k, v in parameters.items()}
    imported: List[str] = []
    by_shape: Dict[tuple, List[str]] = {}
    for k, v in ours.items():
        by_shape.setdefault(tuple(v.shape), []).append(k)

    for tname, tval in state_dict.items():
        arr = torch.as_tensor(tval).detach()
        target = None
        if name_map and tname in name_map:
            target = name_map[tname]
        elif tname in ours:
            target = tname
        else:
            cands = by_shape.get(tuple(arr.shape), [])
            cands_t = by_shape.get(tuple(arr.T.shape), []) \
                if arr.ndim == 2 else []
            if len(cands) == 1:
                target = cands[0]
            elif not cands and len(cands_t) == 1 and transpose_linear:
                target = cands_t[0]
        if target is None:
            continue
        dst = ours[target]
        if tuple(arr.shape) != tuple(dst.shape):
            if transpose_linear and arr.ndim == 2 \
                    and tuple(arr.T.shape) == tuple(dst.shape):
                arr = arr.T
            else:
                continue
        elif (transpose_linear and arr.ndim == 2
              and arr.shape[0] == arr.shape[1]
              and tname.rsplit(".", 1)[-1] == "weight"):
            # square torch Linear weights match both ways; torch stores
            # [out, in], so '*.weight' still needs the transpose (pass a
            # name_map for square embedding tables named '.weight')
            arr = arr.T
        parameters[target] = arr.contiguous().to(device=dst.device,
                                                 dtype=dst.dtype)
        imported.append(target)
    return imported
