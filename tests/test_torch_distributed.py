"""The multi-process entry point (``parallel/distributed.py``) and a mesh
spread over a process group (``parallel/mesh.py``): the port's counterparts
of the reference's ``tests/test_distributed.py``, with CPU processes on
gloo. Each worker process imports only the port; the logical mesh it is
held against runs in the test's own process.

- Two processes: a ``shard_map`` ``psum`` of each process's value gives
  3.0; one data-parallel gradient step from each process's half-batch gives
  the same gradient in both, bitwise the logical ``(2,)`` mesh's; two
  ``ParallelWrapper`` steps on the process-group mesh, from the JAX
  network's weights, end bitwise the logical ``(2,)`` wrapper's and within
  1e-5 rel-to-max of the JAX ``ParallelWrapper`` on two of conftest's CPU
  devices; a sharded checkpoint of a ZeRO state's data-axis rows restores
  each process's row, and a restore of another dtype or another topology's
  save raises.
- Four processes (``slow``, as the reference's): a ``(2, 2)`` mesh, the
  collectives on each axis, and a sharded checkpoint with one file a
  process and the manifest from process 0."""
import _torch_threads  # noqa: F401
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
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
from deeplearning4j_tpu_torch.parallel import distributed
from deeplearning4j_tpu_torch.parallel.mesh import pmean, shard_map

_COMMON = textwrap.dedent("""
import os
import sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.parallel import distributed
from deeplearning4j_tpu_torch.parallel.mesh import pmean, psum, shard_map

pid, port, world = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
distributed.initialize_distributed(f"127.0.0.1:{port}", world, pid,
                                   device="cpu")
assert distributed.process_count() == world
assert distributed.process_index() == pid


def hexbytes(t):
    return t.detach().contiguous().numpy().tobytes().hex()


def must_raise(fn, match):
    try:
        fn()
    except ValueError as e:
        assert match in str(e), e
    else:
        raise AssertionError(f"no ValueError ({match})")
""")

_WORKER2 = _COMMON + textwrap.dedent("""
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.zero import ZERO_STATE_KEY
from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
    restore_sharded_checkpoint, save_sharded_checkpoint)

tmp = sys.argv[4]
mesh = distributed.global_mesh(("data",))
assert mesh.size == 2 and mesh.world == 2

# psum across processes: each holds its own value
f = shard_map(lambda a: psum(a, mesh, "data"), mesh=mesh,
              in_specs=(("data",),), out_specs=())
out = f(torch.tensor([float(pid + 1)]))
assert float(out[0]) == 3.0, out

# one data-parallel gradient step from this process's half-batch
W = torch.ones(4, 2)
xs = torch.tensor([[1., 2., 3., 4.], [5., 6., 7., 8.]]) * (pid + 1)


def body(x_rows, w_rows):
    grads = []
    for i in range(x_rows.shape[0]):
        w = w_rows[i].clone().requires_grad_(True)
        loss = ((x_rows[i] @ w) ** 2).mean()
        grads.append(torch.autograd.grad(loss, w)[0])
    return pmean(torch.stack(grads), mesh, "data")


g = shard_map(body, mesh=mesh, in_specs=(("data",), ()),
              out_specs=())(xs, W)
print("GRAD", pid, hexbytes(g), flush=True)

# two ParallelWrapper steps, each process fed the same global batches
conf = (NeuralNetConfiguration(seed=5, updater=Adam(1e-2))
        .list(tl.DenseLayer(n_in=4, n_out=8, activation="tanh"),
              tl.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .build())
net = MultiLayerNetwork(conf, device="cpu").init()
z = np.load(os.path.join(tmp, "weights.npz"))
load_jax_params(net, [{k: z[f"{i}_{k}"] for k in ("W", "b")}
                      for i in range(2)])
x, y = z["x"], z["y"]
ParallelWrapper(net, mesh=mesh, prefetch_buffer=0).fit(
    ListDataSetIterator(features=x, labels=y, batch_size=8))
print("PARAMS", pid, hexbytes(net.params_flat()), flush=True)

# a sharded checkpoint of a ZeRO state: each process saves and restores its
# data-axis row; another dtype, shape or topology is refused
state = torch.arange(6.0).reshape(2, 3)
tree = {"opt": {ZERO_STATE_KEY: state[pid:pid + 1].clone()},
        "b": torch.arange(3.0)}
ckpt = os.path.join(tmp, "ckpt")
save_sharded_checkpoint(ckpt, 3, tree, mesh=mesh)
like = {"opt": {ZERO_STATE_KEY: torch.zeros(1, 3)}, "b": torch.zeros(3)}
got = restore_sharded_checkpoint(ckpt, 3, like, mesh=mesh)
assert torch.equal(got["opt"][ZERO_STATE_KEY], state[pid:pid + 1])
assert torch.equal(got["b"], tree["b"])
for bad in ({"opt": {ZERO_STATE_KEY: torch.zeros(1, 3, dtype=torch.float64)},
             "b": torch.zeros(3)},
            {"opt": {ZERO_STATE_KEY: torch.zeros(1, 4)}, "b": torch.zeros(3)},
            {"opt": {ZERO_STATE_KEY: torch.zeros(1, 3)},
             "b": torch.zeros(3, dtype=torch.float64)}):
    must_raise(lambda: restore_sharded_checkpoint(ckpt, 3, bad, mesh=mesh),
               "different mesh topology")
# a save from the logical (4,) mesh: four data-axis rows, not two
other = os.path.join(tmp, f"logical{pid}")
save_sharded_checkpoint(other, 3, {"opt": {ZERO_STATE_KEY: torch.zeros(4, 3)},
                                   "b": torch.arange(3.0)},
                        mesh=make_mesh((4,), ("data",), "cpu"))
must_raise(lambda: restore_sharded_checkpoint(other, 3, like, mesh=mesh),
           "different mesh topology")
distributed.shutdown_distributed()
print(f"WORKER_{pid}_OK", flush=True)
""")

_WORKER4 = _COMMON + textwrap.dedent("""
from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
    restore_sharded_checkpoint, save_sharded_checkpoint)

ckpt = sys.argv[4]
mesh = distributed.global_mesh(("data", "model"), shape=(2, 2))
d, m = mesh.coords(pid)
assert (d, m) == divmod(pid, 2)

# the collectives on each axis: the sum over this process's line
v = torch.tensor([[float(10 * d + m)]])
on_model = psum(v, mesh, "model")
on_data = psum(v, mesh, "data")
assert float(on_model[0, 0]) == 20 * d + 1, on_model
assert float(on_data[0, 0]) == 10 + 2 * m, on_data

# a column-parallel product: W's columns over 'model', x's rows over 'data'
W = torch.arange(16, dtype=torch.float32).reshape(4, 4)
x = torch.arange(32, dtype=torch.float32).reshape(8, 4) / 10.0
w_rows = W[:, 2 * m:2 * m + 2].unsqueeze(0)          # [1, 4, 2]
x_local = x[4 * d:4 * d + 4]
y = x_local @ w_rows[0]
torch.testing.assert_close(y, (x @ W)[4 * d:4 * d + 4, 2 * m:2 * m + 2])

# a sharded checkpoint: one file a process, the manifest from process 0
tree = {"W": w_rows, "b": torch.arange(3.0)}
save_sharded_checkpoint(ckpt, 11, tree, specs={"W": (None, "model"),
                                               "b": ()}, mesh=mesh)
names = set(os.listdir(ckpt))
assert {"ckpt_step11.json"} | {f"ckpt_step11_p{i:03d}.npz"
                               for i in range(4)} <= names, names
like = {"W": torch.zeros(1, 4, 2), "b": torch.zeros(3)}
got = restore_sharded_checkpoint(ckpt, 11, like, mesh=mesh)
assert torch.equal(got["W"], w_rows) and torch.equal(got["b"], tree["b"])
for bad in ({"W": torch.zeros(1, 4, 2, dtype=torch.float64),
             "b": torch.zeros(3)},
            {"W": torch.zeros(1, 4, 4), "b": torch.zeros(3)}):
    must_raise(lambda: restore_sharded_checkpoint(ckpt, 11, bad, mesh=mesh),
               "different mesh topology")
distributed.shutdown_distributed()
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
    env["OMP_NUM_THREADS"] = "1"
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


def _tagged(outs, tag):
    got = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith(tag + " "):
                _, pid, value = line.split()
                got[int(pid)] = value
    return got


def _hex(t):
    return t.detach().contiguous().numpy().tobytes().hex()


def _conf(conf_cls, layers, upd):
    return (conf_cls(seed=5, updater=upd)
            .list(layers.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                  layers.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
            .build())


def test_two_process_cpu_distributed(tmp_path):
    jnet = JMLN(_conf(JConf, jl, jupd.Adam(1e-2))).init()
    weights = {f"{i}_{k}": np.asarray(v, np.float32)
               for i, p in enumerate(jnet.params) for k, v in p.items()}
    rng = np.random.default_rng(0)
    xx = rng.normal(size=(16, 4)).astype(np.float32)
    yy = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    np.savez(tmp_path / "weights.npz", x=xx, y=yy, **weights)
    outs = _run(_WORKER2, 2, str(tmp_path))
    grads = _tagged(outs, "GRAD")
    assert grads[0] == grads[1]
    # the logical (2,) mesh on the global batch, in this process
    mesh = make_mesh((2,), ("data",), "cpu")
    x = torch.tensor([[1., 2., 3., 4.], [5., 6., 7., 8.]])
    xs = torch.cat([x, 2 * x])

    def body(x_rows, w_rows):
        gs = []
        for i in range(x_rows.shape[0]):
            w = w_rows[i].clone().requires_grad_(True)
            gs.append(torch.autograd.grad(((x_rows[i] @ w) ** 2).mean(),
                                          w)[0])
        return pmean(torch.stack(gs), mesh, "data")

    want = shard_map(body, mesh=mesh, in_specs=(("data",), ()),
                     out_specs=())(xs, torch.ones(4, 2))
    assert grads[0] == _hex(want)
    params = _tagged(outs, "PARAMS")
    assert params[0] == params[1]
    net = MultiLayerNetwork(_conf(NeuralNetConfiguration, tl, Adam(1e-2)),
                            device="cpu").init()
    load_jax_params(net, [{k: weights[f"{i}_{k}"] for k in ("W", "b")}
                          for i in range(2)])
    ParallelWrapper(net, mesh=mesh, prefetch_buffer=0).fit(
        ListDataSetIterator(features=xx, labels=yy, batch_size=8))
    assert params[0] == _hex(net.params_flat())
    # the JAX wrapper on two of conftest's CPU devices, same weights, rows
    JPW(jnet, mesh=jmesh.make_mesh((2,), ("data",), jax.devices()[:2]),
        prefetch_buffer=0).fit(JIter(features=xx, labels=yy, batch_size=8))
    got = np.frombuffer(bytes.fromhex(params[0]), np.float32)
    want = np.asarray(jnet.params_flat(), np.float32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.slow
def test_four_process_mesh_and_distributed_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    _run(_WORKER4, 4, ckpt, timeout=240)
    with open(os.path.join(ckpt, "ckpt_step11.json")) as f:
        assert json.load(f)["num_processes"] == 4


def test_entry_points_without_a_group():
    """Before ``initialize_distributed`` this process is rank 0 of 1 and
    ``global_mesh`` refuses; a shape that does not cover the processes'
    workers is refused as the reference refuses it."""
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        distributed.global_mesh(("data",))
    with pytest.raises(ValueError, match="does not spread"):
        make_mesh((2, 2), ("data", "model"), "cpu", world=2)
    with pytest.raises(ValueError, match="one worker a process"):
        make_mesh((4,), ("data",), "cpu", world=2)


def test_one_process_group_mesh_is_the_logical_mesh():
    """A one-process gloo group: the mesh's one worker's collectives go
    through the group and give the logical ``(1,)`` mesh's bits; a shape
    that does not cover its worker is refused, and so is a model axis
    over processes (ROADMAP A7b-4b)."""
    port = _free_port()
    distributed.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                       device="cpu")
    try:
        with pytest.raises(ValueError, match="must cover all 1"):
            distributed.global_mesh(("data",), shape=(2,))
        mesh = distributed.global_mesh(("data",))
        assert mesh.shape == {"data": 1} and mesh.group is not None
        logical = make_mesh((1,), ("data",), "cpu")
        x = torch.randn(1, 5, generator=torch.Generator().manual_seed(0))
        assert torch.equal(pmean(x, mesh, "data"),
                           pmean(x, logical, "data"))
        rng = np.random.default_rng(0)
        xx = rng.normal(size=(16, 4)).astype(np.float32)
        yy = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        nets = []
        for m in (mesh, logical):
            net = MultiLayerNetwork(_conf(NeuralNetConfiguration, tl,
                                          Adam(1e-2)), device="cpu").init()
            ParallelWrapper(net, mesh=m, prefetch_buffer=0).fit(
                ListDataSetIterator(features=xx, labels=yy, batch_size=8))
            nets.append(net)
        assert torch.equal(nets[0].params_flat(), nets[1].params_flat())
        # a model axis over processes is the one path refused (a (1, 2)
        # mesh on the group: the refusal comes before any collective)
        with pytest.raises(ValueError,
                           match="process-group mesh.*A7b-4b"):
            ParallelWrapper(nets[0], mesh=make_mesh(
                (1, 2), ("data", "model"), "cpu", group=mesh.group,
                rank=0, world=2))
    finally:
        distributed.shutdown_distributed()
