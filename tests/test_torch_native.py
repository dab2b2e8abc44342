"""``paddle_tpu_torch.native`` against ``paddle_tpu.native`` on the CPU.

- recordio: the port's native writer, index and chunk reader against
  both packages' Python recordio and the JAX package's native library —
  the same records and the same offsets, each direction;
- the shuffle pool: every record once, shuffled; at a window of 1 the
  same sequence as the JAX package's pool (a wider window's order depends
  on how far the producer thread is ahead, in both packages);
- the MLP of ``test_native.test_shuffle_pool_as_trainer_reader`` trained
  over the port's pool, and the JAX package's trainer over the same
  records in the order the pool gave them: the same costs;
- the C ABI: the JAX package's ``C_TEST`` client on the port's
  ``libptpu_capi`` over a model merged on the CPU equals JAX's forward;
  the source imports only the port's exporter;
- the AOT runtime built by the port: no libpython, no libtorch; the
  shared-parameter client over two threads; the malicious programs of
  ``test_native.py`` refused as the JAX package's build refuses them;
- a build that fails raises with the compiler's output.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import ctypes
import json
import os
import re
import subprocess
import sysconfig

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import native as jnative
from paddle_tpu.master import recordio as jrio

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import convert, native
from paddle_tpu_torch import export as texport
from paddle_tpu_torch.master import recordio as trio
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.tools import export_workload as ew

from test_native import (C_AOT_SHARED_TEST, C_TEST, _write_ptnm)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the C ABI's output against JAX's forward (the JAX package's own bound
# for its C ABI test)
CAPI_ATOL = 1e-4
# the trainer over the pool against JAX's over the same records: Adam at
# 0.05, f32 sums in other orders.  The first pass's 4 costs part by at
# most 2.7e-7 (measured over 12 pool orders); later, Adam turns a
# gradient entry near 0 whose sign the two packages round apart into a
# full lr step, and the costs (down to ~3e-3) part by up to 4.6e-5
FIRST_PASS_ATOL = 1e-6
COST_ATOL = 2e-4


@pytest.fixture(scope="module")
def jnat(tmp_path_factory):
    """The JAX package's native bindings, its libraries built into a
    private directory: its build step writes ``native/build/`` in place, and
    a worker running ``tests/test_native.py`` at the same time must never
    load a library this module's build is still writing."""
    build = str(tmp_path_factory.mktemp("jax_native_build"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_BUILD", build)
        mp.setattr(jnative, "_LIB_PATH", os.path.join(build, "libptn.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_error", None)
        assert jnative.available(), jnative._load_error
        yield jnative


def _records(n, tag="record"):
    return [f"{tag}-{i}".encode() * (i + 1) for i in range(n)]


def test_recordio_interop_across_packages(jnat, tmp_path):
    """Port native writes -> both Python readers and JAX's native reader
    read; both Python writers -> the port's native reader reads; the
    offsets agree everywhere."""
    recs = _records(20)
    p1 = str(tmp_path / "port_native.rio")
    assert native.write_records(p1, recs) == 20
    offs = trio.recordio_index(p1)
    assert offs == jrio.recordio_index(p1) == native.index(p1) \
        == jnat.index(p1)
    assert trio.recordio_read_chunk(p1, 0, 20) == recs
    assert jrio.recordio_read_chunk(p1, 0, 20) == recs
    assert jnat.read_chunk(p1, offs[5], 3) == recs[5:8]
    for i, write in enumerate((trio.recordio_write, jrio.recordio_write,
                               jnat.write_records)):
        p = str(tmp_path / f"w{i}.rio")
        write(p, recs)
        assert native.read_chunk(p, 0, 20) == recs
        assert native.read_chunk(p, offs[5], 3) == recs[5:8]   # a seek
        assert native.index(p) == offs
        with open(p, "rb") as a, open(p1, "rb") as b:
            assert a.read() == b.read()


def _parts(tmp_path, n_files=3, n=50):
    files = []
    for fi in range(n_files):
        p = str(tmp_path / f"part-{fi}.rio")
        native.write_records(p, [f"f{fi}-r{i}".encode() for i in range(n)])
        files.append(p)
    return files


def test_shuffle_pool_streams_all_records(jnat, tmp_path):
    files = _parts(tmp_path)
    sequential = [f"f{fi}-r{i}".encode() for fi in range(3)
                  for i in range(50)]
    got = list(native.recordio_reader(files, window=16, seed=7)())
    jgot = list(jnat.recordio_reader(files, window=16, seed=7)())
    assert len(got) == len(jgot) == 150
    assert sorted(got) == sorted(jgot) == sorted(sequential)
    assert got != sequential            # shuffled
    # a window of one leaves the producer no slack: both pools give the
    # files' order
    one = list(native.recordio_reader(files, window=1, seed=7)())
    assert one == list(jnat.recordio_reader(files, window=1, seed=7)()) \
        == sequential
    # str paths, a missing file raising, close() twice
    assert len(list(native.recordio_reader(files[0], window=4)())) == 50
    with pytest.raises(OSError, match="shuffle pool IO error"):
        list(native.recordio_reader([str(tmp_path / "none.rio")])())
    pool = native.ShufflePool(files, window=4, seed=1)
    pool.close()
    pool.close()


def _mlp(P):
    P.topology.reset_name_scope()
    x = P.layer.data(name="x", type=P.data_type.dense_vector(8))
    y = P.layer.data(name="y", type=P.data_type.integer_value(2))
    return P.layer.classification_cost(input=P.layer.fc(x, size=2), label=y)


def _costs(P, sgd, reader_creator, passes):
    costs = []

    def handler(ev):
        if isinstance(ev, P.event.EndIteration):
            costs.append(float(ev.cost))

    sgd.train(P.batch(reader_creator, 32), num_passes=passes,
              event_handler=handler)
    return costs


def test_trainer_over_the_native_pool_matches_jax(tmp_path):
    """The port's SGD over its native pool (window 32, seed 1, 6 passes)
    and the JAX package's SGD over the same records in the order the pool
    handed them out: the same costs, and the model learns."""
    rng = np.random.RandomState(0)
    rows = []
    for _ in range(128):
        y = int(rng.randint(0, 2))
        x = (rng.randn(8) * 0.2).astype(np.float32)
        x[y * 4:(y + 1) * 4] += 1.0
        rows.append(json.dumps({"x": x.tolist(), "y": y}).encode())
    path = str(tmp_path / "train.rio")
    native.write_records(path, rows)

    def parse(rec):
        o = json.loads(rec)
        return np.asarray(o["x"], np.float32), o["y"]

    jcost = _mlp(jpaddle)
    jparams = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology([jcost]), seed=0)
    arrays = {k: np.asarray(v) for k, v in jparams.as_dict().items()}
    tcost = _mlp(tpaddle)
    tsgd = tpaddle.trainer.SGD(
        cost=tcost, parameters=convert.parameters_from_numpy(
            arrays, device="cpu"),
        update_equation=tpaddle.optimizer.Adam(learning_rate=0.05),
        device="cpu")
    orders = []
    raw = native.recordio_reader(path, window=32, seed=1)

    def pooled():
        orders.append([])
        for rec in raw():
            orders[-1].append(rec)
            yield parse(rec)

    got = _costs(tpaddle, tsgd, pooled, passes=6)
    assert len(orders) == 6 and all(sorted(o) == sorted(rows)
                                    for o in orders)
    jsgd = jpaddle.trainer.SGD(
        cost=jcost, parameters=jparams,
        update_equation=jpaddle.optimizer.Adam(learning_rate=0.05))
    replay = iter(orders)

    def in_pool_order():
        return (parse(r) for r in next(replay))

    want = _costs(jpaddle, jsgd, in_pool_order, passes=6)
    np.testing.assert_allclose(got[:4], want[:4], atol=FIRST_PASS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=COST_ATOL, rtol=0)
    assert got[-1] < 0.5 * got[0] and want[-1] < 0.5 * want[0]


def test_c_abi_runs_the_jax_client_on_the_port(tmp_path):
    """The JAX package's C client, linked against the port's
    ``libptpu_capi``, infers a model the port merged on the CPU: equal to
    JAX's forward on the same weights."""
    jpaddle.topology.reset_name_scope()
    jx = jpaddle.layer.data(name="x", type=jpaddle.data_type.dense_vector(8))
    jout = jpaddle.layer.fc(jpaddle.layer.fc(jx, size=16, act="relu"),
                            size=3, act="softmax")
    jtopo = jpaddle.topology.Topology([jout])
    jparams = jpaddle.Parameters.from_topology(jtopo, seed=0)
    tpaddle.topology.reset_name_scope()
    tx = tpaddle.layer.data(name="x", type=tpaddle.data_type.dense_vector(8))
    tout = tpaddle.layer.fc(tpaddle.layer.fc(tx, size=16, act="relu"),
                            size=3, act="softmax")
    tparams = convert.parameters_from_numpy(
        {k: np.asarray(v) for k, v in jparams.as_dict().items()},
        device="cpu")
    model_path = str(tmp_path / "model.ptm")
    texport.merge_model(tout, tparams, model_path, device="cpu")

    capi_so = native.build_capi()
    csrc = tmp_path / "ctest.c"
    csrc.write_text(C_TEST)
    exe = str(tmp_path / "ctest")
    subprocess.run(["gcc", "-o", exe, str(csrc), capi_so,
                    f"-Wl,-rpath,{os.path.dirname(capi_so)}",
                    f"-Wl,-rpath,{sysconfig.get_config_var('LIBDIR')}"],
                   check=True, capture_output=True)
    proc = subprocess.run([exe, model_path], capture_output=True, text=True,
                          env=ew.capi_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    vals = proc.stdout.split()
    rows, cols = int(vals[0]), int(vals[1])
    got = np.asarray([float(v) for v in vals[2:]]).reshape(rows, cols)
    xb = (np.arange(16, dtype=np.float32) / 16.0).reshape(2, 8)
    expect, _ = jtopo.forward(jparams.as_dict(), jtopo.init_state(),
                              {"x": xb}, train=False)
    np.testing.assert_allclose(got, np.asarray(expect[0]), atol=CAPI_ATOL)


def test_capi_source_imports_only_the_port():
    """``capi.cpp`` embeds the port's exporter and never names the JAX
    package (``paddle_tpu_torch`` starts with ``paddle_tpu``: match the
    dotted name exactly)."""
    src = open(native.CAPI_SRC).read()
    assert re.findall(r'PyImport_ImportModule\("([^"]+)"\)', src) \
        == ["paddle_tpu_torch.export"]
    assert not re.search(r"paddle_tpu\.", src)


def test_aot_runtime_links_no_python_and_no_torch():
    out = ew.ldd_libs(native.build_aot())
    assert "libpython" not in out and "libtorch" not in out, out
    assert "libpython" not in ew.ldd_libs(native.build())


def test_aot_shared_param_client_runs_clean(tmp_path):
    """Two threads infer through shared handles over one weight copy, the
    origin released first: every output bit-identical (the JAX package's
    ``C_AOT_SHARED_TEST`` client on the port's program and build)."""
    tpaddle.topology.reset_name_scope()
    x = tpaddle.layer.data(name="x", type=tpaddle.data_type.dense_vector(8))
    out = tpaddle.layer.fc(tpaddle.layer.fc(x, size=16, act="relu"),
                           size=3, act="softmax")
    params = tpaddle.Parameters.from_topology(
        tpaddle.topology.Topology([out]), seed=0, device="cpu")
    model = str(tmp_path / "shared.ptnm")
    texport.export_aot_program(out, params, model, batch_size=2,
                               device="cpu")
    aot_so = native.build_aot()
    csrc = tmp_path / "shared_client.c"
    csrc.write_text(C_AOT_SHARED_TEST)
    exe = str(tmp_path / "shared_client")
    subprocess.run(["gcc", "-pthread", "-o", exe, str(csrc), aot_so,
                    f"-Wl,-rpath,{os.path.dirname(aot_so)}"],
                   check=True, capture_output=True)
    proc = subprocess.run([exe, model], capture_output=True, text=True,
                          timeout=120, env={})
    assert proc.returncode == 0, (proc.returncode, proc.stderr)
    assert proc.stdout.startswith("OK")


def test_aot_validator_refuses_what_the_jax_build_refuses(jnat, tmp_path):
    """The malicious programs of ``test_native.py`` (gather width, DOT
    output size, def-before-use, negative dim, shrinking RESHAPE, CONCAT
    overflow, undefined output, a clobbered weight) and a well-formed one:
    the port's build of ``aot_runtime.cpp`` gives the JAX build's
    verdict on each."""
    E = texport
    progs = {
        "ok": ([(0, (2, 3)), (0, (3, 4)), (0, (2, 4))], [(0, "x")], [2],
               [(1, np.zeros((3, 4)))], [(E.OP_DOT, [0, 1], 2, [])]),
        "gather": ([(0, (5, 4)), (0, (3, 1)), (0, (3, 8))], [(1, "ids")],
                   [2], [(0, np.zeros((5, 4)))],
                   [(E.OP_GATHER_ROWS, [0, 1], 2, [])]),
        "dot": ([(0, (2, 3)), (0, (3, 4)), (0, (2, 2))], [(0, "x")], [2],
                [(1, np.zeros((3, 4)))], [(E.OP_DOT, [0, 1], 2, [])]),
        "undef": ([(0, (2, 3)), (0, (2, 3)), (0, (2, 3))], [(0, "x")], [2],
                  [], [(E.OP_IDENT, [1], 2, [])]),
        "negdim": ([(0, (-4, 2)), (0, (2, 2))], [(0, "x")], [1], [],
                   [(E.OP_IDENT, [0], 1, [])]),
        "reshape": ([(0, (2, 2)), (0, (4, 4))], [(0, "x")], [1], [],
                    [(E.OP_RESHAPE, [0], 1, [])]),
        "concat": ([(0, (2, 3)), (0, (2, 3)), (0, (5, 3))],
                   [(0, "x"), (1, "y")], [2], [],
                   [(E.OP_CONCAT, [0, 1], 2, [0])]),
        "outundef": ([(0, (2, 3)), (0, (2, 3))], [(0, "x")], [1], [], []),
        "clobber": ([(0, (2, 3)), (0, (2, 3))], [(0, "x")], [1],
                    [(1, np.zeros((2, 3)))], [(E.OP_IDENT, [0], 1, [])]),
    }

    def loader(path):
        lib = ctypes.CDLL(path)
        lib.ptpu_aot_load.restype = ctypes.c_void_p
        lib.ptpu_aot_load.argtypes = [ctypes.c_char_p]
        lib.ptpu_aot_release.argtypes = [ctypes.c_void_p]
        return lib

    port, ref = loader(native.build_aot()), loader(jnat.build_aot())
    verdicts = {}
    for name, spec in progs.items():
        path = str(tmp_path / f"{name}.ptnm")
        _write_ptnm(path, *spec)
        got = []
        for lib in (port, ref):
            h = lib.ptpu_aot_load(path.encode())
            got.append(bool(h))
            if h:
                lib.ptpu_aot_release(h)
        verdicts[name] = got
    assert verdicts == {name: [name == "ok"] * 2 for name in progs}


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(EnforceError, match=r"building libbroken failed"
                                           r"(.|\n)*error"):
        native._compile("broken", [bad])
    with pytest.raises(EnforceError, match="no native source"):
        native._compile("missing", [tmp_path / "none.cpp"])
