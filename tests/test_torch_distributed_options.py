"""The data axis' options over processes (``parallel/mesh.py``,
``parallel/zero.py``, ``parallel/accumulation.py``,
``parallel/data_parallel.py`` on a ``distributed.global_mesh``), with CPU
processes on gloo. Each worker process imports only the port; the logical
mesh it is held against runs in the test's own process.

- Two processes, one spawn: from the JAX network's weights (the small MLP
  of ``tests/test_torch_distributed.py``), ZeRO stages 1 and 2 (Adam), the
  ``EncodedAccumulator``'s dense and topk encoders and K-step averaging
  (``averaging_frequency=2``, ``average_updaters`` on and off) and
  ``overlap_sync`` (buckets of 64 bytes) each end
  bitwise the logical ``(2,)`` wrapper's: parameters, the gathered updater
  state (without ``average_updaters`` each process's own worker's), the
  accumulator's carry row. A process's ZeRO state is ``[1, length]``,
  1/n of the replicated bytes plus padding. The bytes a process hands
  ``torch.distributed`` a step are counted by wrapping its calls in the
  child: ZeRO-2's gradient sync hands at most (n-1)/n of its padded
  bucket, the dense encoder one byte an element. A sharded checkpoint of
  the ZeRO-2 fit written a process restores bitwise into the logical
  wrapper's tree, and the logical wrapper's into each process's rows.
  ZeRO-2 and averaging also land within 1e-5 rel-to-max of the JAX
  ``ParallelWrapper`` on two of conftest's CPU devices.
- Four processes: every collective on a ``(4,)`` mesh bitwise the
  logical mesh's, at a size that pads; the children import torch and
  ``parallel/mesh.py`` only."""
import _torch_threads  # noqa: F401
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.accumulation import EncodedAccumulator
from deeplearning4j_tpu_torch.parallel.data_parallel import \
    flat_opt_state_order
from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
    restore_sharded_checkpoint, save_sharded_checkpoint, tree_flatten)

N, STEPS, LR, THRESHOLD = 2, 4, 1e-2, 1e-2
# mode -> ParallelWrapper options (the accumulators built from the names)
MODES = {
    "zero1": dict(zero_stage=1),
    "zero2": dict(zero_stage=2),
    "dense": dict(gradient_accumulator=("dense", None)),
    "topk": dict(gradient_accumulator=("topk", 0.25)),
    "avg": dict(training_mode="averaging", averaging_frequency=2),
    "avg_own": dict(training_mode="averaging", averaging_frequency=2,
                    average_updaters=False),
    "overlap": dict(overlap_sync=True, bucket_bytes=64),
}

_WORKER2 = textwrap.dedent("""
import json
import os
import sys
import numpy as np
import torch
import torch.distributed as dist
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, distributed
from deeplearning4j_tpu_torch.parallel.accumulation import EncodedAccumulator
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    flat_opt_state_order)
from deeplearning4j_tpu_torch.parallel.zero import (ZERO_STATE_KEY,
                                                    ZeroUpdateEngine)
from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
    restore_sharded_checkpoint, save_sharded_checkpoint)

pid, port, world, tmp = (int(sys.argv[1]), sys.argv[2], int(sys.argv[3]),
                         sys.argv[4])
STEPS = int(sys.argv[6])
modes = json.loads(sys.argv[5])
distributed.initialize_distributed(f"127.0.0.1:{port}", world, pid,
                                   device="cpu")
mesh = distributed.global_mesh(("data",))

# the bytes this process hands torch.distributed, by the seam it is in
handed, seam = {}, ["other"]


def counting(fn):
    def wrapped(out, inp, *a, **kw):
        handed[seam[0]] = handed.get(seam[0], 0) + \\
            inp.numel() * inp.element_size()
        return fn(out, inp, *a, **kw)
    return wrapped


for name in ("all_to_all_single", "all_gather_into_tensor",
             "all_gather_single"):
    if hasattr(dist, name):
        setattr(dist, name, counting(getattr(dist, name)))


def in_seam(cls, meth, name):
    fn = getattr(cls, meth)

    def wrapped(self, *a, **kw):
        seam[0] = name
        try:
            return fn(self, *a, **kw)
        finally:
            seam[0] = "other"
    setattr(cls, meth, wrapped)


in_seam(ZeroUpdateEngine, "grad_sync", "grad_sync")
in_seam(EncodedAccumulator, "combine", "combine")


def hexbytes(t):
    return t.detach().contiguous().numpy().tobytes().hex()


def tree_leaves(tree):
    from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
        tree_flatten)
    return tree_flatten(tree)[0]


z = np.load(os.path.join(tmp, "weights.npz"))
x, y = z["x"], z["y"]
rows = {}
for mode, kw in modes.items():
    kw = dict(kw)
    if "gradient_accumulator" in kw:
        enc, frac = kw["gradient_accumulator"]
        kw["gradient_accumulator"] = EncodedAccumulator(
            threshold=float(z["threshold"]), encoder=enc,
            capacity_fraction=frac)
    conf = (NeuralNetConfiguration(seed=5, updater=Adam(float(z["lr"])))
            .list(tl.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                  tl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    load_jax_params(net, [{k: z[f"{i}_{k}"] for k in ("W", "b")}
                          for i in range(2)])
    pw = ParallelWrapper(net, mesh=mesh, prefetch_buffer=0, **kw)
    handed.clear()
    pw.fit(ListDataSetIterator(features=x, labels=y, batch_size=8))
    row = {"bytes": dict(handed)}
    if kw.get("zero_stage"):
        eng = pw._zero()
        row["zero_shapes"] = [list(v.shape) for g in
                              net.opt_state[ZERO_STATE_KEY]
                              for v in g.values()]
        row["shard_bytes"] = eng.shard_state_bytes
        row["replicated_bytes"] = eng.replicated_state_bytes
        row["bucket_bytes"] = [world * b.lb * 4 for g in eng.groups
                               for b in g.buckets]
        if mode == "zero2":
            # this fit's ZeRO-2 state saved a process, and the logical
            # (2,) wrapper's save restored into this process's rows
            tree = {"params": net.param_dicts(), "opt": net.opt_state}
            save_sharded_checkpoint(os.path.join(tmp, "pg"), STEPS, tree,
                                    sharding=eng.sharding_meta(), mesh=mesh)
            got = restore_sharded_checkpoint(os.path.join(tmp, "logical"),
                                             STEPS, tree, mesh=mesh)
            row["restored"] = hexbytes(torch.cat(
                [t.reshape(-1) for t in tree_leaves(got)]))
            row["own"] = hexbytes(torch.cat(
                [t.reshape(-1) for t in tree_leaves(tree)]))
        pw.gather_opt_state()
    if pw._acc_state is not None:
        row["carry_shape"] = list(pw._acc_state.shape)
        row["carry"] = hexbytes(pw._acc_state[0])
    row["params"] = hexbytes(net.params_flat())
    row["opt"] = hexbytes(torch.cat([t.reshape(-1) for *_, t in
                                     flat_opt_state_order(net)]))
    rows[mode] = row
distributed.shutdown_distributed()
print("ROWS", pid, json.dumps(rows), flush=True)
print(f"WORKER_{pid}_OK", flush=True)
""")

# the children import torch and parallel/mesh.py (and the device module it
# reads) only: the parallel package's __init__ is left out
_WORKER4 = textwrap.dedent("""
import importlib
import os
import sys
import types
import torch
import torch.distributed as dist
import deeplearning4j_tpu_torch as pkg
par = types.ModuleType("deeplearning4j_tpu_torch.parallel")
par.__path__ = [os.path.join(os.path.dirname(pkg.__file__), "parallel")]
sys.modules[par.__name__] = par
tm = importlib.import_module("deeplearning4j_tpu_torch.parallel.mesh")

pid, port, world = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=pid)
mesh = tm.make_mesh((world,), ("data",), "cpu", group=dist.group.WORLD,
                    rank=pid, world=world)
handed = []
fn = dist.all_to_all_single


def counting(out, inp, *a, **kw):
    handed.append(inp.numel() * inp.element_size())
    return fn(out, inp, *a, **kw)


dist.all_to_all_single = counting
gen = torch.Generator().manual_seed(11)
x = torch.randn(world, 5, 3, generator=gen)          # 15: pads to 16
parts = torch.randn(world, world, 7, generator=gen)
mine = lambda t: t[pid:pid + 1]


def show(name, t):
    print("OUT", pid, name, t.contiguous().numpy().tobytes().hex(),
          flush=True)


show("psum", tm.psum(mine(x), mesh, "data"))
show("pmean", tm.pmean(mine(x), mesh, "data"))
handed.clear()
show("psum_scatter", tm.psum_scatter(mine(parts), mesh, "data"))
assert handed == [(world - 1) * 7 * 4], handed   # (n-1)/n of the row
show("all_gather", tm.all_gather(mine(x), mesh, "data"))
show("all_to_all", tm.all_to_all(mine(parts), mesh, "data"))
show("ppermute_next", tm.ppermute_next(mine(x), mesh, "data"))
show("axis_index", tm.axis_index(mesh, "data"))
assert "deeplearning4j_tpu_torch.parallel.data_parallel" not in sys.modules
dist.destroy_process_group()
print(f"WORKER_{pid}_OK", flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(script, world, *extra, timeout=180):
    port = _free_port()
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", str(torch.get_num_threads()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(i), str(port), str(world),
         *extra], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(world)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"WORKER_{i}_OK" in out
    return outs


def _hex(t):
    return t.detach().contiguous().numpy().tobytes().hex()


def _conf(conf_cls, layers, upd):
    return (conf_cls(seed=5, updater=upd)
            .list(layers.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                  layers.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
            .build())


def _options(kw):
    kw = dict(kw)
    if "gradient_accumulator" in kw:
        enc, frac = kw["gradient_accumulator"]
        kw["gradient_accumulator"] = EncodedAccumulator(
            threshold=THRESHOLD, encoder=enc, capacity_fraction=frac)
    return kw


def _logical(mode, weights, xx, yy, tmp):
    """The logical ``(2,)`` wrapper in this process, from the weights;
    ZeRO-2's state is saved to ``tmp/logical`` and its tree returned
    before the state is gathered."""
    net = MultiLayerNetwork(_conf(NeuralNetConfiguration, tl, Adam(LR)),
                            device="cpu").init()
    load_jax_params(net, [{k: weights[f"{i}_{k}"] for k in ("W", "b")}
                          for i in range(2)])
    pw = ParallelWrapper(net, mesh=make_mesh((N,), ("data",), "cpu"),
                         prefetch_buffer=0, **_options(MODES[mode]))
    pw.fit(ListDataSetIterator(features=xx, labels=yy, batch_size=8))
    tree = {"params": {k: {n: p.detach().clone() for n, p in d.items()}
                       for k, d in net.param_dicts().items()},
            "opt": tmesh._tree_map(torch.clone, net.opt_state)}
    if mode == "zero2":
        save_sharded_checkpoint(str(tmp / "logical"), STEPS, tree,
                                sharding=pw._zero().sharding_meta())
    pw.gather_opt_state()
    return net, pw, tree


def _opt_hex(net):
    return _hex(torch.cat([t.reshape(-1) for *_, t in
                           flat_opt_state_order(net)]))


def _rel_to_max(got_hex, want):
    got = np.frombuffer(bytes.fromhex(got_hex), np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_two_processes_run_every_data_axis_option(tmp_path):
    jnet = JMLN(_conf(JConf, jl, jupd.Adam(LR))).init()
    weights = {f"{i}_{k}": np.asarray(v, np.float32)
               for i, p in enumerate(jnet.params) for k, v in p.items()}
    rng = np.random.default_rng(3)
    xx = rng.normal(size=(8 * STEPS, 4)).astype(np.float32)
    yy = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8 * STEPS)]
    np.savez(tmp_path / "weights.npz", x=xx, y=yy, threshold=THRESHOLD,
             lr=LR, **weights)
    # the logical (2,) wrapper first: its ZeRO-2 save is the children's
    logical = {mode: _logical(mode, weights, xx, yy, tmp_path)
               for mode in MODES}
    outs = _run(_WORKER2, N, str(tmp_path), json.dumps(MODES), str(STEPS))
    ranks = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("ROWS "):
                _, pid, body = line.split(" ", 2)
                ranks[int(pid)] = json.loads(body)
    size = int(sum(np.prod(v.shape) for v in weights.values()))
    for mode in MODES:
        r0, r1 = ranks[0][mode], ranks[1][mode]
        assert r0["params"] == r1["params"], mode
        net, pw, tree = logical[mode]
        assert r0["params"] == _hex(net.params_flat()), mode
        if mode == "avg_own":
            # each process keeps its own worker's updater state: rank 0's
            # is the logical wrapper's worker 0's, rank 1's its worker 1's
            assert r0["opt"] == _opt_hex(net), mode
            assert r1["opt"] == _hex(torch.cat(
                [t.reshape(-1) for t in pw._worker_opt[1]])), mode
            assert r0["opt"] != r1["opt"]
        else:
            assert r0["opt"] == r1["opt"] == _opt_hex(net), mode
        if mode.startswith("zero"):
            for r in (r0, r1):
                assert all(s[0] == 1 for s in r["zero_shapes"]), r
                # Adam: m and v, one shard of the padded layout each
                assert r["shard_bytes"] * N >= r["replicated_bytes"]
                assert r["shard_bytes"] * N - r["replicated_bytes"] <= \
                    2 * 4 * (N - 1) * len(r["bucket_bytes"])
        if mode == "zero2":
            # a process-group save restores bitwise into the logical
            # wrapper's tree, and the logical save into each process's rows
            got = restore_sharded_checkpoint(str(tmp_path / "pg"), STEPS,
                                             tree)
            assert all(torch.equal(a, b) for a, b in zip(
                tree_flatten(got)[0], tree_flatten(tree)[0]))
            for r in (r0, r1):
                assert r["restored"] == r["own"]
            # the reduce-scatter hands (n-1)/n of each padded bucket
            bound = sum(b * (N - 1) // N for b in r0["bucket_bytes"])
            assert r0["bytes"]["grad_sync"] == STEPS * bound, r0["bytes"]
        if mode in ("dense", "topk"):
            for k, r in enumerate((r0, r1)):
                assert r["carry_shape"] == [1, size]
                assert r["carry"] == _hex(pw._acc_state[k]), (mode, k)
        if mode == "dense":
            # the int8 sign map: one byte an element a step
            assert r0["bytes"]["combine"] == STEPS * size, r0["bytes"]
        if mode in ("zero2", "avg"):
            kw = dict(zero_stage=2) if mode == "zero2" else dict(
                training_mode="averaging", averaging_frequency=2)
            jn = JMLN(_conf(JConf, jl, jupd.Adam(LR))).init()
            JPW(jn, mesh=jmesh.make_mesh((N,), ("data",),
                                         jax.devices()[:N]),
                prefetch_buffer=0, **kw).fit(
                JIter(features=xx, labels=yy, batch_size=8))
            want = np.asarray(jn.params_flat(), np.float32)
            assert _rel_to_max(r0["params"], want) <= 1e-5, mode


def test_four_process_collectives_are_the_logical_mesh():
    outs = _run(_WORKER4, 4)
    got = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("OUT "):
                _, pid, name, value = line.split()
                got[(int(pid), name)] = value
    mesh = make_mesh((4,), ("data",), "cpu")
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(4, 5, 3, generator=gen)
    parts = torch.randn(4, 4, 7, generator=gen)
    want = {"psum": tmesh.psum(x, mesh, "data"),
            "pmean": tmesh.pmean(x, mesh, "data"),
            "psum_scatter": tmesh.psum_scatter(parts, mesh, "data"),
            "all_gather": tmesh.all_gather(x, mesh, "data"),
            "all_to_all": tmesh.all_to_all(parts, mesh, "data"),
            "ppermute_next": tmesh.ppermute_next(x, mesh, "data"),
            "axis_index": tmesh.axis_index(mesh, "data")}
    for name, rows in want.items():
        for pid in range(4):
            assert got[(pid, name)] == _hex(rows[pid:pid + 1]), (pid, name)
