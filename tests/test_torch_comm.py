"""The port's spike-exchange collectives (``repro_torch.core.comm``) on gloo
worlds of CPU processes, against the JAX package's wire format and the
results ``tests/test_comm.py`` holds its ``shard_map`` gathers to.

Also home of :func:`run_world`, which the port's distributed tests share: it
spawns one ``torch.distributed`` process per mesh position (gloo, ``file://``
rendezvous under the test's ``tmp_path``), runs one function of a test
module on every rank and returns every rank's result. Module tops stay free
of JAX imports, since every rank imports its test module.
"""

import datetime
import importlib
import json
import math
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 300


def run_world(tmp_path, shape, axis_names, target: str, payload=None, *,
              device="cpu") -> list:
    """Run ``target`` (``"module:function"``, called as ``fn(mesh, payload)``)
    on every rank of a gloo world over a ``ProcessMesh(shape, axis_names,
    device=device)`` (None: the mesh's default, the GPU); return the
    ranks' results in rank order. Any rank failing fails the call, with
    every failed rank's stderr."""
    world = math.prod(shape)
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "payload.pkl").write_bytes(pickle.dumps(payload))
    spec = dict(init=f"file://{tmp_path}/store", shape=list(shape), names=list(axis_names),
                target=target, dir=str(tmp_path), device=device)
    env = {**os.environ, "TORCH_WORLD": json.dumps(spec), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])}
    procs = []
    for rank in range(world):
        log = open(tmp_path / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import test_torch_comm as w; w.rank_main()"],
            env={**env, "RANK": str(rank)}, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = {r: (p.returncode, (tmp_path / f"rank{r}.log").read_text()[-4000:])
              for r, p in enumerate(procs) if p.returncode != 0}
    assert not failed, failed
    return [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def rank_main() -> None:
    """One rank of :func:`run_world` (run in its own process)."""
    import torch.distributed as dist

    from repro_torch.core.mesh import ProcessMesh

    spec = json.loads(os.environ["TORCH_WORLD"])
    rank = int(os.environ["RANK"])
    shape = tuple(spec["shape"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=spec["init"], world_size=math.prod(shape),
                            rank=rank, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        mesh = ProcessMesh(shape, spec["names"], device=spec["device"])
        module, fn = spec["target"].split(":")
        payload = pickle.loads((Path(spec["dir"]) / "payload.pkl").read_bytes())
        result = getattr(importlib.import_module(module), fn)(mesh, payload)
        out = Path(spec["dir"]) / f"rank{rank}.pkl"
        out.with_suffix(".tmp").write_bytes(pickle.dumps(result))
        os.replace(out.with_suffix(".tmp"), out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The wire format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4, 8, 24, 37])
def test_pack_bits_matches_jax(n):
    """``pack_bits`` / ``unpack_bits`` bit for bit the JAX package's, for
    widths below, on and off a byte."""
    from repro.core import comm as jcomm

    from repro_torch.core import comm

    x = np.random.default_rng(n).integers(0, 2, (3, 5, n)).astype(np.int8)
    got = comm.pack_bits(torch.from_numpy(x))
    want = np.asarray(jcomm.pack_bits(x))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    back = comm.unpack_bits(got, n)
    assert back.dtype == torch.int8 and np.array_equal(back.numpy(), x)
    assert np.array_equal(back.numpy(), np.asarray(jcomm.unpack_bits(want, n)))


def test_byte_accounting_matches_jax():
    """The cost model's per-gather and count-collective bytes."""
    from repro.core import comm as jcomm

    from repro_torch.core import comm

    for shape, n, b in (((2, 3), 4, 1), ((10, 4, 16), 8, 4), ((7,), 1, 2)):
        assert comm.exchange_bytes(shape, n, b) == jcomm.exchange_bytes(shape, n, b)
    for words, n in ((1, 8), (40, 4)):
        assert comm.count_wire_bytes(words, n) == jcomm.count_wire_bytes(words, n)


# ---------------------------------------------------------------------------
# Gathers and count collectives on a (2, 2, 2) world
# ---------------------------------------------------------------------------

AXES = ("pod", "data", "model")
A_LOC, D = 2, 3


def comm_cases(mesh, data):
    """Every rank's gathers of its shard of the payload's global arrays."""
    from repro_torch.core import comm

    g = mesh.axis_index("pod") * mesh.shape["data"] + mesh.axis_index("data")
    lane, rank = mesh.axis_index("model"), mesh.rank
    out = {}
    for n_loc, (spk, blk, spk2) in data.items():
        rows = slice(g * A_LOC, (g + 1) * A_LOC)
        cols = slice(lane * n_loc, (lane + 1) * n_loc)
        s = torch.from_numpy(spk[rows, cols].copy())
        b = torch.from_numpy(blk[:, rows, cols].copy())
        s2 = torch.from_numpy(spk2[:, rank * n_loc:(rank + 1) * n_loc].copy())
        for packed in (True, False):
            out[n_loc, "area", packed] = comm.gather_area(
                s, mesh, subgroup_axis="model", packed=packed).numpy()
            out[n_loc, "global", packed] = comm.gather_global(
                b, mesh, area_axes=("pod", "data"), subgroup_axis="model", packed=packed).numpy()
            out[n_loc, "full", packed] = comm.gather_full(s2, mesh, AXES, packed=packed).numpy()
    out["max_all"] = comm.count_max(torch.tensor(rank * 7 % 5), mesh, AXES)
    out["max_lane"] = comm.count_max(torch.tensor(rank), mesh, "model")
    counts = torch.arange(D * A_LOC, dtype=torch.int32).view(D, A_LOC) * 100 + rank
    out["counts"] = comm.gather_counts(counts, mesh, area_axes=("pod", "data"),
                                       subgroup_axis="model").numpy()
    # ppermute over the (pod, data) group index: every group sends to the
    # next but one, group 3 to nobody; group 1 receives nothing.
    x = torch.full((D, 2), 10 * g + lane, dtype=torch.int32)
    out["ppermute"] = comm.ppermute(x, mesh, ("pod", "data"), PPERMUTE_PAIRS, fill=-7).numpy()
    out["calls"] = dict(comm.calls)
    return out


PPERMUTE_PAIRS = ((0, 2), (1, 3), (2, 0))


def test_gathers_and_counts_on_a_2x2x2_world(tmp_path):
    """``gather_area`` / ``gather_global`` / ``gather_full``, packed and
    unpacked, at per-shard widths 24 and 4 (as ``tests/test_comm.py``):
    every rank receives exactly the global arrays its shard was cut from,
    global areas in row-major (pod, data) order. ``count_max`` is the
    maximum over the axes asked for, ``gather_counts`` the subgroup sum
    concatenated over the area groups. ``ppermute`` moves each group's
    tensor to its pair's destination at the same lane (``jax.lax.ppermute``
    on the (pod, data) axes), and a group no pair sends to gets the fill."""
    data = {}
    for n_loc in (24, 4):
        rng = np.random.default_rng(n_loc)
        data[n_loc] = (rng.integers(0, 2, (A_LOC * 4, 2 * n_loc)).astype(np.int8),
                       rng.integers(0, 2, (D, A_LOC * 4, 2 * n_loc)).astype(np.int8),
                       rng.integers(0, 2, (A_LOC, 8 * n_loc)).astype(np.int8))
    results = run_world(tmp_path, (2, 2, 2), AXES, "test_torch_comm:comm_cases", data)
    for rank, got in enumerate(results):
        g, lane = rank // 2, rank % 2
        for n_loc, (spk, blk, spk2) in data.items():
            for packed in (True, False):
                assert np.array_equal(got[n_loc, "area", packed],
                                      spk[g * A_LOC:(g + 1) * A_LOC]), (rank, n_loc, packed)
                assert np.array_equal(got[n_loc, "global", packed], blk), (rank, n_loc, packed)
                assert np.array_equal(got[n_loc, "full", packed], spk2), (rank, n_loc, packed)
        assert got["max_all"] == max(r * 7 % 5 for r in range(8))
        assert got["max_lane"] == rank | 1
        base = np.arange(D * A_LOC).reshape(D, A_LOC) * 100
        want = np.concatenate([2 * base + (2 * gg) + (2 * gg + 1) for gg in range(4)], axis=1)
        assert np.array_equal(got["counts"], want), rank
        sender = {dst: src for src, dst in PPERMUTE_PAIRS}.get(g)
        assert np.array_equal(got["ppermute"], np.full(
            (D, 2), -7 if sender is None else 10 * sender + lane)), rank
        assert got["calls"][("ppermute", ("pod", "data"))] == 1
        # One gather per pathway stage: the subgroup, then each area axis.
        calls = got["calls"]
        assert calls[("all_gather", ("model",))] == 2 * 2 * 2
        assert calls[("all_gather", ("data",))] == calls[("all_gather", ("pod",))] == 2 * 2 + 1
        assert calls[("all_gather", AXES)] == 2 * 2
