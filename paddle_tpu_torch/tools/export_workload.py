"""The exporter, the native runtime and the static analysis on the card:
``chip_smoke.py``'s ``export``, ``native`` and ``analysis`` phases, and
the C clients that drive the two C inference surfaces.

- :func:`export_phase`: ResNet-50 at bench.py's width (depth 50, 224 px,
  1000 classes; weights from seed 0 through ``convert.
  parameters_from_numpy``) merged on the card with a symbolic batch,
  loaded and run at batches 1 and 8, run again through the C ABI
  (``native/capi.cpp``) from a C client in a subprocess, and exported as a
  ``.ptnm`` program at batch 1 that ``native/src/aot_runtime.cpp`` runs on
  the host in a client process with no Python; LeNet at 28 px through the
  AOT path at batch 4.  Every output is held against the port's eager
  forward on the card.
- :func:`native_phase`: seeded LeNet samples written to recordio with the
  native writer, one training pass on the card through
  ``native.recordio_reader`` -> ``SGD.train``, held against the same
  samples fed as a list in the pool's order.
- :func:`analysis_phase`: ``lint``, ``guarded-by`` and ``state-table``
  over the tree through the analysis CLI's ``main`` (exit 0), then the
  kill-partition chaos drive explored on the card at a small budget, the
  ragged kernel's launches counted and one of the drive's kernel calls
  held against the plain version on the same tensors.

Times are host clock after a sync, the median after a warm-up.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]

# One C client for both surfaces: load the model once, then for each
# (batch, input file, output file) run ``reps`` inferences of that batch
# (timing each) and write the last output.  PTPU_LOAD / PTPU_INFER /
# PTPU_RELEASE name the surface's symbols.
_CLIENT = r"""
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

extern void* PTPU_LOAD(const char* path);
extern int PTPU_INFER(void* h, const char* name, const float* data,
                      long long batch, long long dim, float* out,
                      long long cap, long long* rows, long long* cols);
extern void PTPU_RELEASE(void* h);

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + t.tv_nsec * 1e-9;
}

int main(int argc, char** argv) {
  if (argc < 8 || (argc - 5) % 3 != 0) {
    fprintf(stderr, "usage: %s model name dim reps "
            "(batch in.f32 out.f32)...\n", argv[0]);
    return 64;
  }
  long long dim = atoll(argv[3]);
  int reps = atoi(argv[4]);
  double t0 = now();
  void* m = PTPU_LOAD(argv[1]);
  if (!m) { fprintf(stderr, "load failed\n"); return 1; }
  printf("load_s %.6f\n", now() - t0);
  long long cap = 1024, rows = 0, cols = 0;
  float* out = (float*)malloc(sizeof(float) * cap);
  for (int a = 5; a < argc; a += 3) {
    long long batch = atoll(argv[a]);
    float* in = (float*)malloc(sizeof(float) * batch * dim);
    FILE* f = fopen(argv[a + 1], "rb");
    if (!f || fread(in, sizeof(float), batch * dim, f) !=
                  (size_t)(batch * dim))
      return 65;
    fclose(f);
    for (int r = 0; r < reps; ++r) {
      t0 = now();
      int rc = PTPU_INFER(m, argv[2], in, batch, dim, out, cap, &rows,
                          &cols);
      double ms = (now() - t0) * 1e3;
      if (rc == -2 && rows * cols > cap) {  /* resize and retry */
        cap = rows * cols;
        out = (float*)realloc(out, sizeof(float) * cap);
        --r;
        continue;
      }
      if (rc != 0) { fprintf(stderr, "infer rc=%d\n", rc); return 2; }
      printf("ms %lld %.6f\n", batch, ms);
    }
    f = fopen(argv[a + 2], "wb");
    if (!f || fwrite(out, sizeof(float), rows * cols, f) !=
                  (size_t)(rows * cols))
      return 66;
    fclose(f);
    printf("shape %lld %lld %lld\n", batch, rows, cols);
    free(in);
  }
  PTPU_RELEASE(m);
  return 0;
}
"""

_SYMBOLS = {"aot": ("ptpu_aot_load", "ptpu_aot_infer", "ptpu_aot_release"),
            "capi": ("ptpu_model_load", "ptpu_infer", "ptpu_model_release")}


def client_source(surface: str) -> str:
    load, infer, release = _SYMBOLS[surface]
    return (_CLIENT.replace("PTPU_LOAD", load).replace("PTPU_INFER", infer)
            .replace("PTPU_RELEASE", release))


def build_client(surface: str, lib: str, out_dir: str) -> str:
    """``gcc`` the client of ``surface`` ('aot' or 'capi') against
    ``lib``; returns the executable."""
    import sysconfig

    src = os.path.join(out_dir, f"{surface}_client.c")
    exe = os.path.join(out_dir, f"{surface}_client")
    with open(src, "w") as f:
        f.write(client_source(surface))
    rpaths = [os.path.dirname(lib)]
    if surface == "capi":
        rpaths.append(sysconfig.get_config_var("LIBDIR"))
    proc = subprocess.run(
        ["gcc", "-O2", "-o", exe, src, lib,
         *(f"-Wl,-rpath,{p}" for p in rpaths)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the {surface} client failed:\n"
                           f"{proc.stderr}")
    return exe


def capi_env() -> Dict[str, str]:
    """The C ABI client's environment: this one, with only the repository
    on PYTHONPATH (the embedded interpreter imports paddle_tpu_torch)."""
    return dict(os.environ, PYTHONPATH=str(REPO))


def run_client(exe: str, model: str, xs, name: str, reps: int, env=None,
               timeout: float = 900) -> Dict:
    """Run a client on each of ``xs`` ([batch, dim] arrays, one array or
    a list) in one process; returns the load seconds and, a batch in
    ``xs``'s order, its output and per-call ms (one entry if ``xs`` is
    one array)."""
    single = isinstance(xs, np.ndarray)
    xs = [np.ascontiguousarray(x, dtype=np.float32)
          for x in ([xs] if single else xs)]
    with tempfile.TemporaryDirectory(prefix="client_") as tmp:
        argv = [exe, model, name, str(xs[0].shape[1]), str(reps)]
        for i, x in enumerate(xs):
            src = os.path.join(tmp, f"in{i}.f32")
            x.tofile(src)
            argv += [str(x.shape[0]), src, os.path.join(tmp, f"out{i}.f32")]
        proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(exe)} exit "
                               f"{proc.returncode}: {proc.stderr[-2000:]}")
        lines = [ln.split() for ln in proc.stdout.splitlines() if ln.strip()]
        shapes = [ln[2:] for ln in lines if ln[0] == "shape"]
        runs = []
        for i, x in enumerate(xs):
            rows, cols = (int(v) for v in shapes[i])
            runs.append({
                "out": np.fromfile(os.path.join(tmp, f"out{i}.f32"),
                                   np.float32).reshape(rows, cols),
                "ms": [float(ln[2]) for ln in lines if ln[0] == "ms"
                       and int(ln[1]) == x.shape[0]]})
    load_s = float(next(ln for ln in lines if ln[0] == "load_s")[1])
    if single:
        return dict(runs[0], load_s=load_s)
    return {"load_s": load_s, "runs": runs}


def ldd_libs(path: str) -> str:
    return subprocess.run(["ldd", path], capture_output=True, text=True,
                          check=True).stdout


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


# ---------------------------------------------------------------------------
# export: ResNet-50 merged, through the C ABI, and as a .ptnm program
# ---------------------------------------------------------------------------

EXPORT_IMG = 224   # bench.py's ResNet-50 width
MERGE_BATCHES = (1, 8)
# merged and the C ABI against eager on the card: the same ATen ops on
# the same inputs with cuDNN's heuristics picking the same algorithms, so
# they agree exactly on the H100 (0.0 at both batches); the limit leaves
# room for a reduction reordered, not for a drifted program
MERGE_RTOL = 1e-6
# the f32 .ptnm on the host against the f32 card forward, TF32 off
AOT_RTOL = 1e-4


def _numpy_params(topo, seed: int) -> Dict[str, np.ndarray]:
    from paddle_tpu_torch.parameters import Parameters

    host = Parameters.from_topology(topo, seed=seed, device="cpu")
    return {k: v.numpy() for k, v in host.as_dict().items()}


def _eager(topo, params, name: str, dev):
    def run(x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            y = topo.forward(params, {name: torch.from_numpy(x).to(dev)},
                             train=False)[0]
        return y.float().cpu().numpy()
    return run


def _aot_case(out_node, params, name: str, batch: int, dim: int, dev,
              exe: str, tmp: str, reps: int, seed: int) -> Dict:
    """Export ``out_node`` as a .ptnm at ``batch``, run it through the
    AOT client with no Python in its process, hold it against the f32
    card forward."""
    from paddle_tpu_torch import export as pexport
    from paddle_tpu_torch.platform.flags import FLAGS
    from paddle_tpu_torch.topology import Topology

    path = os.path.join(tmp, f"{name}_b{batch}.ptnm")
    t0 = time.perf_counter()
    pexport.export_aot_program(out_node, params, path, batch_size=batch,
                               device=dev)
    export_s = time.perf_counter() - t0
    x = np.random.RandomState(seed).rand(batch, dim).astype(np.float32)
    run = run_client(exe, path, x, name, reps, env={})
    old = FLAGS.use_bf16
    FLAGS.use_bf16 = False
    try:
        want = _eager(Topology([out_node]), params.as_dict(), name, dev)(x)
    finally:
        FLAGS.use_bf16 = old
    return {"batch": batch, "export_s": export_s,
            "ptnm_bytes": os.path.getsize(path),
            "host_ms": float(np.median(run["ms"])), "host_ms_all": run["ms"],
            "rel_err_vs_card_f32": rel_err(run["out"], want)}


def export_phase(dev, card: str) -> List[Dict]:
    from paddle_tpu_torch import convert, native
    from paddle_tpu_torch import export as pexport
    from paddle_tpu_torch.models import lenet, resnet
    from paddle_tpu_torch.topology import Topology, reset_name_scope

    tmp = tempfile.mkdtemp(prefix="export_")
    bench = torch.backends.cudnn.benchmark
    # eager and merged pick their convolutions by the same heuristics
    torch.backends.cudnn.benchmark = False
    try:
        reset_name_scope()
        _, _, logits, _ = resnet.build(depth=50, img_size=EXPORT_IMG,
                                       num_classes=1000)
        topo = Topology([logits])
        params = convert.parameters_from_numpy(_numpy_params(topo, 0),
                                               device=dev)
        name, dim = "image", 3 * EXPORT_IMG * EXPORT_IMG
        eager = _eager(topo, params.as_dict(), name, dev)
        path = os.path.join(tmp, "resnet50.ptm")
        t0 = time.perf_counter()
        pexport.merge_model(logits, params, path, device=dev)
        merge_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        merged = pexport.load_merged_model(path)
        load_s = time.perf_counter() - t0
        capi = build_client("capi", native.build_capi(), tmp)
        xs = [np.random.RandomState(b).rand(b, dim).astype(np.float32)
              for b in MERGE_BATCHES]
        abi = run_client(capi, path, xs, name, reps=6, env=capi_env())
        per_batch = {}
        for b, x, run in zip(MERGE_BATCHES, xs, abi["runs"]):
            want = eager(x)
            got = merged.infer({name: x})[0]
            per_batch[b] = {
                "merged_rel_err": rel_err(got, want),
                "capi_rel_err": rel_err(run["out"], want),
                "merged_ms": _median_ms(lambda: merged.infer({name: x}), 5),
                "eager_ms": _median_ms(lambda: eager(x), 5),
                # the first call of a batch pays its first run
                "capi_ms": float(np.median(run["ms"][1:])),
                "out_shape": list(got.shape),
                "finite": bool(np.isfinite(got).all())}
        aot_lib = native.build_aot()
        libs = ldd_libs(aot_lib)
        aot = build_client("aot", aot_lib, tmp)
        res_aot = _aot_case(logits, params, name, 1, dim, dev, aot, tmp,
                            reps=2, seed=11)
        reset_name_scope()
        _, _, lenet_logits, _ = lenet.build(img_size=28)
        lenet_topo = Topology([lenet_logits])
        lenet_params = convert.parameters_from_numpy(
            _numpy_params(lenet_topo, 0), device=dev)
        lenet_aot = _aot_case(lenet_logits, lenet_params, "pixel", 4, 784,
                              dev, aot, tmp, reps=5, seed=12)
        res = {"phase": "export", "model": "resnet50", "img": EXPORT_IMG,
               "classes": 1000, "merge_s": merge_s,
               "artifact_bytes": os.path.getsize(path),
               "load_s": load_s, "capi_load_s": abi["load_s"],
               "symbolic_batch": merged.manifest["symbolic_batch"],
               "batches": per_batch,
               "aot_resnet50": res_aot, "aot_lenet": lenet_aot,
               "aot_lib_links_python": "libpython" in libs,
               "aot_lib_links_torch": "libtorch" in libs,
               "timer": "host clock after a sync, median after warm-up; "
                        "the .ptnm runs on the host",
               "nvidia_smi": card}
        bad = [f"batch {b}: {k} {v[k]:.3g}" for b, v in per_batch.items()
               for k in ("merged_rel_err", "capi_rel_err")
               if not v[k] <= MERGE_RTOL]
        bad += [f"batch {b} not finite" for b, v in per_batch.items()
                if not v["finite"]]
        bad += [f"{n} AOT rel err {r['rel_err_vs_card_f32']:.3g}"
                for n, r in (("resnet50", res_aot), ("lenet", lenet_aot))
                if not r["rel_err_vs_card_f32"] <= AOT_RTOL]
        if res["aot_lib_links_python"] or res["aot_lib_links_torch"]:
            bad.append(f"libptpu_aot links Python or torch:\n{libs}")
        res["failures"] = bad
        print(json.dumps(res), flush=True)
        if bad:
            raise AssertionError(f"export failed: {bad}")
        return [res]
    finally:
        torch.backends.cudnn.benchmark = bench
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# native: LeNet trained on the card through the native shuffle pool
# ---------------------------------------------------------------------------

NATIVE_SAMPLES = 512
NATIVE_BATCH = 64
NATIVE_WINDOW = 128
NATIVE_SEED = 3


def lenet_records(n: int, seed: int) -> List[bytes]:
    """Seeded LeNet samples as records: an int32 label, then 784 f32
    pixels."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = int(rng.randint(0, 10))
        x = (rng.rand(784) * 0.2).astype(np.float32)
        x[y * 78:(y + 1) * 78] += 0.8
        out.append(struct.pack("<i", y) + x.tobytes())
    return out


def parse_record(rec: bytes):
    (y,) = struct.unpack_from("<i", rec)
    return np.frombuffer(rec, np.float32, offset=4).copy(), y


def _lenet_trainer(dev, numpy_params):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import convert, optimizer, trainer
    from paddle_tpu_torch.models import lenet

    paddle.topology.reset_name_scope()
    _, _, _, cost = lenet.build(img_size=28)
    if numpy_params is None:
        numpy_params = _numpy_params(paddle.topology.Topology([cost]), 0)
    params = convert.parameters_from_numpy(numpy_params, device=dev)
    sgd = trainer.SGD(cost=cost, parameters=params, device=dev,
                      update_equation=optimizer.Momentum(momentum=0.9,
                                                         learning_rate=0.01))
    return sgd, numpy_params


def _train_costs(sgd, reader) -> List[float]:
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import event

    costs: List[float] = []

    def handler(ev):
        if isinstance(ev, event.EndIteration):
            costs.append(float(ev.cost))

    sgd.train(paddle.batch(reader, NATIVE_BATCH), num_passes=1,
              event_handler=handler)
    return costs


def native_phase(dev, card: str) -> List[Dict]:
    from paddle_tpu_torch import native

    tmp = tempfile.mkdtemp(prefix="native_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        native.build()
        build_s = time.perf_counter() - t0
        records = lenet_records(NATIVE_SAMPLES, seed=0)
        half = NATIVE_SAMPLES // 2
        paths = [os.path.join(tmp, f"part-{i}.rio") for i in range(2)]
        t0 = time.perf_counter()
        written = sum(native.write_records(p, records[i * half:
                                                      (i + 1) * half])
                      for i, p in enumerate(paths))
        write_s = time.perf_counter() - t0
        offsets = [native.index(p) for p in paths]
        seen: List[bytes] = []

        def pooled():
            for rec in native.recordio_reader(paths, window=NATIVE_WINDOW,
                                              seed=NATIVE_SEED)():
                seen.append(rec)
                yield parse_record(rec)

        sgd, start = _lenet_trainer(dev, None)
        t0 = time.perf_counter()
        costs = _train_costs(sgd, pooled)
        pool_s = time.perf_counter() - t0
        order = list(seen)
        twin, _ = _lenet_trainer(dev, start)
        list_costs = _train_costs(
            twin, lambda: (parse_record(r) for r in order))
        res = {"phase": "native", "model": "lenet", "samples": written,
               "files": len(paths), "window": NATIVE_WINDOW,
               "batch": NATIVE_BATCH, "build_s": build_s, "write_s": write_s,
               "pass_s": pool_s, "records_per_file": [len(o)
                                                      for o in offsets],
               "costs": costs, "list_costs": list_costs,
               "costs_equal": costs == list_costs,
               "records_equal": sorted(order) == sorted(records),
               "shuffled": order != records, "nvidia_smi": card}
        print(json.dumps(res), flush=True)
        if not (res["costs_equal"] and res["records_equal"]
                and res["shuffled"] and written == NATIVE_SAMPLES
                and len(costs) == NATIVE_SAMPLES // NATIVE_BATCH
                and np.isfinite(costs).all()):
            raise AssertionError(f"native failed: {res}")
        return [res]
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# analysis: the static gates over the tree, one chaos drive on the card
# ---------------------------------------------------------------------------

ANALYSIS_BUDGET = 8
ANALYSIS_COMMANDS = {
    "lint": ["lint"],
    "guarded_by_state_table": ["concurrency", "--rule", "guarded-by",
                               "--rule", "state-table"],
}
# the drive's first engine calls of the ragged kernel kept for the check
ANALYSIS_CAPTURE = 64


def analysis_kernel_check(calls) -> Dict:
    """Of the drive's captured ragged kernel calls, the one with the most
    real rows, launched again and held against the plain version on the
    same tensors (``ragged_cases.check``: 1e-4 on f32 pages), both timed
    between CUDA events, with the least time for its bytes and
    operations (``ragged_cases.roofline``)."""
    from paddle_tpu_torch.serving.decode_attention import (
        ragged_paged_attention_kernel as kernel,
        ragged_paged_attention_reference as plain)
    from paddle_tpu_torch.tools import ragged_cases as rc
    from paddle_tpu_torch.tools.parallel_workload import events_ms

    def real_rows(call):
        return int((call[0][rc.ARGS.index("qpos")] >= 0).sum())

    args, kw = max(calls, key=real_rows)
    case = dict(zip(rc.ARGS, args))
    case.update({k: v for k, v in kw.items() if v is not None})
    sc = rc.scales(case)
    got = kernel(*rc.args(case), **sc)
    torch.cuda.synchronize()
    return {"q": list(case["q"].shape), "pages": list(case["k_pages"].shape),
            "page_type": str(case["k_pages"].dtype).replace("torch.", ""),
            "real_rows": real_rows((args, kw)), "calls_seen": len(calls),
            **rc.check(case, got), **rc.roofline(case),
            "ms": events_ms(lambda: kernel(*rc.args(case), **sc), 20),
            "plain_ms": events_ms(lambda: plain(*rc.args(case), **sc), 3),
            "timer": "events"}


def analysis_phase(dev, card: str) -> List[Dict]:
    from paddle_tpu_torch.analysis import cli
    from paddle_tpu_torch.analysis.concurrency import schedules
    from paddle_tpu_torch.serving import decode_attention as da
    from paddle_tpu_torch.serving import engine as engine_mod

    codes, tails, secs = {}, {}, {}
    for key, argv in ANALYSIS_COMMANDS.items():
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            codes[key] = cli.main(argv)
        secs[key] = time.perf_counter() - t0
        tails[key] = out.getvalue().strip()[-300:]
    drive = schedules._drive_fleet_kill_partition(device=dev)
    calls: List[tuple] = []
    attn = engine_mod.ragged_paged_attention

    def capturing_attn(*args, **kw):
        if len(calls) < ANALYSIS_CAPTURE:
            calls.append((tuple(x.clone() for x in args),
                           {k: (v.clone() if v is not None else None)
                            for k, v in kw.items()}))
        return attn(*args, **kw)

    engine_mod.ragged_paged_attention = capturing_attn
    try:
        da.ragged_paged_attention_kernel.launches = 0
        t0 = time.perf_counter()
        explored, diags = schedules.explore_drive(drive,
                                                  budget=ANALYSIS_BUDGET)
        drive_s = time.perf_counter() - t0
        launches = da.ragged_paged_attention_kernel.launches
    finally:
        engine_mod.ragged_paged_attention = attn
    check = analysis_kernel_check(calls) if calls else {}
    res = {"phase": "analysis", "exit_codes": codes, "tails": tails,
           "seconds": secs, "drive": drive.name, "budget": ANALYSIS_BUDGET,
           "explored": explored, "diagnostics": [str(d) for d in diags],
           "drive_s": drive_s, "b4_launches": launches,
           "kernel_check": check, "nvidia_smi": card}
    print(json.dumps(res), flush=True)
    if any(codes.values()) or diags or explored != ANALYSIS_BUDGET \
            or launches <= 0 or not check.get("within_tolerance"):
        raise AssertionError(f"analysis failed: {res}")
    return [res]


PHASES = {"export": export_phase, "native": native_phase,
          "analysis": analysis_phase}


def main(argv=None) -> int:
    """The three phases alone, or those named: ``python -m
    paddle_tpu_torch.tools.export_workload [export] [native]
    [analysis]``."""
    names = list(sys.argv[1:] if argv is None else argv) or list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"unknown phase(s) {unknown}; choose from {list(PHASES)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "card", "nvidia_smi": card,
                      "torch": torch.__version__}), flush=True)
    for name in names:
        PHASES[name](dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
