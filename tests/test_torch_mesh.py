"""The port's mesh layer (``ngsbits_tpu_torch/parallel/mesh.py``) on the CPU,
over gloo process groups of 1, 2 and 3 ranks.

Each sharded step runs once a world, in ranks started together
(``mesh.spawn_ranks``: a file store, no port), on inputs made with numpy from
a seed, some with fewer rows than ranks; every rank's results must be the
same. They are then held against the JAX package's step on a one-device JAX
mesh and against its plain function: integers array-equal; the correlation
within 1e-12 of ``np.corrcoef`` in float64 and within 1e-3 of the JAX step's
float32 result (the JAX dryrun's own tolerance). Also: ``distributed_init``
with two real processes, ``dryrun_multichip`` at 1, 2 and 4 ranks, the row
split, the rank's device, and the plain routes of the mesh path's kernel
wrappers at zero rows.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ngsbits_tpu.ops import readqc as jax_readqc
from ngsbits_tpu.ops import seqpurge as jax_seqpurge
from ngsbits_tpu.parallel import mesh as jax_mesh

from ngsbits_tpu_torch import entry
from ngsbits_tpu_torch.ops import device_reduce as dr
from ngsbits_tpu_torch.ops import pallas_kernels as pk
from ngsbits_tpu_torch.parallel import mesh
from ngsbits_tpu_torch.utils import backend

WORLDS = (1, 2, 3)
RANK_TIMEOUT = 120  # seconds a group of ranks may take
CPU_ENV = {"NGSBITS_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}

# step -> (the function in both packages, its arguments' names)
STEPS = {
    "readqc": ("sharded_readqc_step", ("bases", "quals", "lengths")),
    "insert": ("sharded_insert_scan", ("seq1", "seq2rc", "min_len")),
    "coverage": ("sharded_coverage_step", ("starts", "ends", "bins")),
    "counters": ("sharded_mapping_counters_step", ("flags", "mapqs", "on_target")),
    "corr": ("sharded_correlation_step", ("x", "y")),
    "corr_u8": ("sharded_correlation_step", ("x", "y")),
}


def _inputs() -> dict:
    """Each case's inputs, ``{case}/{argument}``; the ``narrow`` cases have
    fewer rows than the widest world."""
    rng = np.random.default_rng(23)
    acgtn = np.frombuffer(b"ACGTN", dtype=np.uint8)
    out = {}
    for case, B, L in (("readqc.wide", 37, 40), ("readqc.narrow", 2, 16)):
        out[f"{case}/bases"] = rng.choice(acgtn, size=(B, L))
        # qualities below Q0 and past Q99 too: the histogram leaves them out
        out[f"{case}/quals"] = rng.integers(20, 140, size=(B, L)).astype(np.uint8)
        out[f"{case}/lengths"] = rng.integers(0, L + 1, size=B).astype(np.int32)
    for case, B, L in (("insert.wide", 29, 33), ("insert.narrow", 1, 8)):
        out[f"{case}/seq1"] = rng.choice(acgtn, size=(B, L))
        out[f"{case}/seq2rc"] = np.where(rng.random((B, L)) < 0.6, out[f"{case}/seq1"],
                                         rng.choice(acgtn, size=(B, L)))
        out[f"{case}/min_len"] = rng.integers(0, L + 1, size=B).astype(np.int32)
    for case, n, bins in (("coverage.wide", 101, 500), ("coverage.narrow", 2, 64)):
        starts = rng.integers(0, bins, size=n).astype(np.int32)
        # empty spans and spans that end at the last bin included
        ends = np.minimum(starts + rng.integers(0, 90, size=n), bins).astype(np.int32)
        out[f"{case}/starts"], out[f"{case}/ends"] = starts, ends
        out[f"{case}/bins"] = np.array(bins)
    for case, n in (("counters.wide", 50), ("counters.narrow", 1)):
        out[f"{case}/flags"] = rng.choice(np.array([0, 0x4, 0x400, 0x404, 0x10], np.uint16), n)
        out[f"{case}/mapqs"] = rng.integers(0, 4, size=n).astype(np.int32)
        out[f"{case}/on_target"] = rng.random(n) < 0.5
    for case, n in (("corr.wide", 97), ("corr.narrow", 2)):
        x = rng.random(n).astype(np.float32)
        out[f"{case}/x"] = x
        out[f"{case}/y"] = (0.5 * x + 0.1 * rng.random(n)).astype(np.float32)
    x = rng.integers(0, 3, size=131).astype(np.uint8)
    out["corr_u8.wide/x"] = x
    out["corr_u8.wide/y"] = np.where(rng.random(131) < 0.7, x,
                                     rng.integers(0, 3, 131)).astype(np.uint8)
    # two genotype pairs, neither vector constant, so r is defined
    out["corr_u8.narrow/x"] = np.array([0, 2], np.uint8)
    out["corr_u8.narrow/y"] = np.array([1, 2], np.uint8)
    return out


CASES = sorted({k.split("/")[0] for k in _inputs()})

_RANK = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from ngsbits_tpu_torch.parallel import mesh
mesh.distributed_init()
grid = mesh.make_mesh()
inp = dict(np.load(sys.argv[1]))
steps = json.loads(sys.argv[3])
out = {}
for case in json.loads(sys.argv[2]):
    name, args = steps[case.split(".")[0]]
    got = getattr(mesh, name)(grid, *[inp[f"{case}/{a}"] for a in args])
    got = got if isinstance(got, tuple) else (got,)
    for k, g in enumerate(got):
        out[f"{case}/{k}"] = g.numpy() if isinstance(g, torch.Tensor) else np.float64(g)
out["world"] = np.array(mesh.world())
np.savez(f"{sys.argv[4]}/rank{mesh.rank()}.npz", **out)
mesh.dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every case through the port's steps at each world: {world: [each
    rank's results]}, the worlds' groups started together."""
    d = tmp_path_factory.mktemp("mesh_steps")
    np.savez(d / "inputs.npz", **_inputs())

    def world(n):
        out = d / f"world{n}"
        out.mkdir()
        res = mesh.spawn_ranks(n, [sys.executable, "-c", _RANK, str(d / "inputs.npz"),
                                   json.dumps(CASES), json.dumps(STEPS), str(out)],
                               env=CPU_ENV, timeout=RANK_TIMEOUT)
        for r, p in enumerate(res):
            assert p.returncode == 0, f"world {n}, rank {r}: {p.stderr[-3000:]}"
        return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        return dict(zip(WORLDS, pool.map(world, WORLDS)))


_JAX: dict = {}


def _jax_step(case: str):
    """The JAX package's step on a one-device mesh, once a case."""
    if case not in _JAX:
        inp = _inputs()
        name, args = STEPS[case.split(".")[0]]
        vals = [inp[f"{case}/{a}"] for a in args]
        if name == "sharded_coverage_step":
            vals[2] = int(vals[2])
        got = getattr(jax_mesh, name)(jax_mesh.make_mesh(jax.devices()[:1]), *vals)
        got = got if isinstance(got, tuple) else (got,)
        _JAX[case] = [np.asarray(g) for g in got]
    return _JAX[case]


def _plain(case: str):
    """The JAX package's plain function (host numpy) on the whole input."""
    inp = {k.split("/")[1]: v for k, v in _inputs().items() if k.startswith(case + "/")}
    step = case.split(".")[0]
    if step == "readqc":
        return list(jax_readqc.readqc_batch_host(inp["bases"], inp["quals"], inp["lengths"]))
    if step == "insert":
        return list(jax_seqpurge.insert_scan_host(inp["seq1"], inp["seq2rc"], inp["min_len"]))
    if step == "coverage":
        diff = np.zeros(int(inp["bins"]) + 1, np.int64)
        np.add.at(diff, inp["starts"], 1)
        np.add.at(diff, inp["ends"], -1)
        return [np.cumsum(diff)[:-1]]
    if step == "counters":
        f, q, t = inp["flags"], inp["mapqs"], inp["on_target"]
        mapped = (f & 0x4) == 0
        return [np.array([len(f), mapped.sum(), ((f & 0x400) != 0).sum(), (mapped & t).sum(),
                          (mapped & (q == 0)).sum()])]
    x, y = inp["x"].astype(np.float64), inp["y"].astype(np.float64)
    return [np.corrcoef(x, y)[0, 1]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_the_jax_step_and_its_plain_function(sharded, case, world):
    ranks = sharded[world]
    assert all(int(r["world"]) == world for r in ranks)
    keys = sorted(k for k in ranks[0] if k.startswith(case + "/"))
    for r in ranks[1:]:  # every rank holds the merged result
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k])
    got = [ranks[0][k] for k in keys]
    want_jax, want_plain = _jax_step(case), _plain(case)
    assert len(got) == len(want_jax) == len(want_plain)
    if case.startswith("corr"):
        assert abs(float(got[0]) - float(want_plain[0])) < 1e-12
        assert abs(float(got[0]) - float(want_jax[0])) < 1e-3
        return
    for g, j, p in zip(got, want_jax, want_plain):
        assert g.shape == j.shape == p.shape
        np.testing.assert_array_equal(g.astype(np.int64), j.astype(np.int64))
        np.testing.assert_array_equal(g.astype(np.int64), p.astype(np.int64))


_INIT = r"""
import sys, torch
from ngsbits_tpu_torch.parallel import mesh
from ngsbits_tpu_torch.utils import backend
pid = int(sys.argv[1])
mesh.distributed_init(sys.argv[2], 2, pid)
mesh.distributed_init(sys.argv[2], 2, pid)  # a no-op once in a group
assert mesh.world() == 2 and mesh.rank() == pid
assert backend.device() == torch.device("cpu")
x = torch.full((8,), pid + 1, dtype=torch.int64)
mesh.all_reduce_(x)
assert x.tolist() == [3] * 8, x
print("OK", mesh.dist.get_backend())
mesh.dist.destroy_process_group()
"""


def test_two_process_distributed_init(tmp_path):
    """The counterpart of tests/test_multichip.py's: two processes join by
    ``distributed_init``'s arguments, see a world of 2, and a sum of pid + 1
    over them gives 3 on both."""
    for p in _two(f"file://{tmp_path / 'store'}"):
        assert p.returncode == 0, p.stderr[-3000:]
        assert p.stdout.strip() == "OK gloo"


def _two(store):
    """Both ranks of ``_INIT``, each given its pid as an argument."""
    env = dict(os.environ, **CPU_ENV)
    env["PYTHONPATH"] = str(mesh._ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _INIT, str(r), store], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    out = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append(subprocess.CompletedProcess(p.args, p.returncode, o, e))
    return out


@pytest.fixture(scope="module")
def dryruns(monkeypatch_module):
    monkeypatch_module.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    monkeypatch_module.setenv("OMP_NUM_THREADS", "1")
    with ThreadPoolExecutor(3) as pool:
        return dict(zip((1, 2, 4), pool.map(
            lambda n: entry.dryrun_multichip(n, timeout=RANK_TIMEOUT), (1, 2, 4))))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("n", (1, 2, 4))
def test_dryrun_multichip(dryruns, n):
    """Every rank ran the five steps (and X7's form) with the JAX dryrun's
    assertions and the checks against the whole input; on the CPU no kernel
    launches."""
    records = dryruns[n]
    assert [r["rank"] for r in records] == list(range(n))
    for r in records:
        assert r["world"] == n and r["backend"] == "gloo" and r["device"] == "cpu"
        steps = [s["step"] for s in r["steps"]]
        assert steps == ["sharded_readqc_step", "sharded_coverage_step",
                         "sharded_insert_scan", "sharded_mapping_counters_step",
                         "sharded_correlation_step", "sharded_correlation_step uint8"]
        assert all(not s["launches"] for s in r["steps"])
        reduced = {s["step"]: s["all_reduce_bytes"] for s in r["steps"]}
        assert reduced["sharded_coverage_step"] == 4 * ((1 << 20) + 1)
        assert reduced["sharded_readqc_step"] == 8 * (6 * 152 + 100)


def test_entry_returns_k1_and_its_example_batch(monkeypatch):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    fn, args = entry.entry()
    bases, quals, lengths = args
    assert bases.shape == (1024, 128) and lengths.dtype == torch.int32
    import __graft_entry__
    for got, want in zip(args, __graft_entry__._example_batch()):
        np.testing.assert_array_equal(got.numpy(), want)
    counts5, qsum, qhist, read_qsum = fn(*args)
    want = jax_readqc.readqc_batch_host(*(a.numpy() for a in args))
    for g, w in zip((counts5, qsum, qhist, read_qsum), want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w, np.int64))


@pytest.mark.parametrize("n", [0, 1, 2, 5, 7, 9])
def test_shard_range_splits_as_tensor_split(n):
    for w in (1, 2, 3, 4):
        parts = torch.tensor_split(torch.arange(n), w)
        got = [mesh.shard_range(n, r, w) for r in range(w)]
        assert [hi - lo for lo, hi in got] == [len(p) for p in parts]
        assert [lo for lo, _ in got] == [int(p[0]) if len(p) else lo for p, (lo, _) in
                                         zip(parts, got)]
        assert got[0][0] == 0 and got[-1][1] == n


def test_without_a_group_every_row_is_this_rank_and_nothing_merges():
    assert not mesh.active()
    assert mesh.rows(7) == (0, 7) and mesh.writes() and mesh.world() == 1
    t = torch.arange(4)
    assert mesh.sum_ranks_(t) is t and t.tolist() == [0, 1, 2, 3]


def test_world_of_one_goes_through_a_group_and_leaves_it(monkeypatch):
    """``run_tool`` at a world of one (no address): a gloo group of this
    process alone while the tool runs, none after; the exit code kept."""
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", mesh.INIT_ENV):
        monkeypatch.delenv(var, raising=False)
    seen = []

    def tool():
        seen.append((mesh.active(), mesh.world(), mesh.dist.get_backend(), backend.device()))
        return 3

    assert mesh.run_tool(tool) == 3
    assert seen == [(True, 1, "gloo", torch.device("cpu"))]
    assert not mesh.active()
    seen.clear()
    assert mesh.run_tool(lambda: tool() and 0) == 0
    assert not mesh.active()


def test_distributed_init_refusals(monkeypatch):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    monkeypatch.delenv(mesh.INIT_ENV, raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="needs an address"):
        mesh.distributed_init(num_processes=2, process_id=0)
    monkeypatch.setenv(mesh.BACKEND_ENV, "nccl")
    with pytest.raises(ValueError, match="NCCL needs"):
        mesh.distributed_init()
    monkeypatch.setenv(mesh.BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="must be 'nccl' or 'gloo'"):
        mesh.distributed_init()
    assert not mesh.active()


# the mesh path's wrappers at zero rows: the plain routes leave every output
# as it was (on the card the launch is skipped: tests/test_torch_kernels_gpu.py)

def test_k1_k2_at_zero_rows_on_the_plain_route():
    bases = torch.zeros((0, 16), dtype=torch.uint8)
    counts5, qsum, qhist = (torch.ones(s, dtype=torch.int64) for s in ((5, 16), 16, 100))
    read_qsum = torch.zeros(0, dtype=torch.int32)
    pk.readqc_batch_into(bases, bases.clone(), torch.zeros(0, dtype=torch.int32), counts5,
                         qsum, qhist, read_qsum)
    assert int(counts5.sum()) == 80 and int(qsum.sum()) == 16 and int(qhist.sum()) == 100
    m = torch.zeros((0, 16), dtype=pk.INSERT_COUNT)
    pk.insert_scan_into(bases, bases.clone(), torch.zeros(0, dtype=torch.int32), m, m.clone())
    assert pk.readqc_batch_into.launches == 0 and pk.insert_scan_into.launches == 0


def test_c1_forms_and_x7_at_zero_rows_on_the_plain_route():
    diff = torch.zeros(33, dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    dr.coverage_add_into(empty, empty.clone(), diff)
    dr.coverage_add_into(empty, None, diff)
    regions = torch.tensor([[1], [32], [0]], dtype=torch.int32)
    dr.coverage_add_reads_into(torch.zeros((4, 0), dtype=torch.int32), regions, diff)
    rec = dr.upload_records(np.zeros(3, np.int32), np.zeros(3, np.int32),
                            np.array([0, 1, 2, 3]), np.full(3, 10 << 4, np.uint32),
                            np.array([0, 10, 20, 30]), np.full(30, 40, np.uint8),
                            device="cpu")
    blocks = torch.tensor([[0], [32], [0]], dtype=torch.int64)
    for baseq in (0, 20):
        dr.coverage_add_records_into(rec, 1, 1, 0, baseq, blocks, diff)
    assert not diff.any()
    out = torch.full((5,), 7, dtype=torch.int64)
    dr.correlation_moments_into(torch.zeros((2, 0), dtype=torch.uint8), out)
    assert out.tolist() == [7] * 5
    # the whole records pass adds; the empty ranges before added nothing
    dr.coverage_add_records_into(rec, 0, 3, 0, 0, blocks, diff)
    assert torch.cumsum(diff, 0)[:10].tolist() == [3] * 10
