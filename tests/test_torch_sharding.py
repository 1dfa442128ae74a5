"""Port parity: observation sharding over ``torch.distributed``.

One module fixture starts ONE two-process gloo job on the CPU
(``tests/torch_sharding_worker.py``, a free local port) that runs every
case on its shard of the tables, while this process computes the
unsharded references: the port's step on the same tables, and the
reference package's unsharded step (its ``tests/test_sharding.py`` and
``tests/test_multiprocess.py`` cases, in float64):

- ``step``: one two-pass step (``test_sharding.py:14``);
- ``optimize``: a full ``optimize`` (``:55``);
- ``grid``: grid-row sharding of the preconditioner (``:75``);
- ``rig2``, ``rig3``: rigs of 2 and 3 cameras (``:116``);
- ``multihost``: each process passes its own rows, 60 % / 40 % of each
  table, and the counts are equalized (``test_multiprocess.py:128``);
- ``direct``, ``direct_points``: one ``schur_direct`` step (poses
  eliminated) and one ``schur_direct_points`` step on tables in grid
  layout, sharded in bands of imagesets (the assembled normal equations
  are summed);
- ``scan``: three cached-blocks steps (``make_lm_scan``);
- ``bands``: one ``schur`` step (points eliminated) of the two-camera rig
  on tables in grid layout, sharded in bands of imagesets: the reduced
  matvec's pose and point legs run on each rank's band
  (``ba/schur_cuda.py``), with t all-reduced between the passes.

Held: both ranks end with the same bits (state, costs, accept decisions,
CG counts); the decisions and CG counts equal the unsharded port run's
and, for the reference's own cases, the reference's; the initial cost
within 1e-9 relative of both, the post-step costs within 1e-3 relative,
the points within 1e-5 (the reference's bars in ``test_sharding.py``),
the grids of the steps within 1e-6; the optimized state's median
reprojection error under 1e-3 px; at least one all-reduce per CG
iteration.  Observed on the development CPU: initial costs within 2e-16
relative of the unsharded port's and 6e-16 of the reference's; post-step
costs within 5.3e-14 after one step and 1.2e-9 after three cached-blocks
steps; points within 8.4e-15 after one step, 1.4e-12 after three and
2.3e-6 after the 25 iterations of ``optimize`` (median 1.4e-5 px).  A
two-rank sum changes only the order of the additions.

The rigs are one problem (``test_sharding.py:116``'s seed 7, three
cameras) and its first one and two cameras, built once.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import ba_harness
import torch_problems
from camera_calibration_torch import convert
from camera_calibration_torch.ba import lm_pcg
from camera_calibration_tpu.ba import dataset as jds
from camera_calibration_tpu.ba import lm_pcg as jlm
from torch_sharding_worker import grid_layout, median_error
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))

# the gloo job runs in the first test's set-up
pytestmark = pytest.mark.timeout(180)

STEP = dict(max_pcg_iterations=25)
# name: (cameras of the rig problem used, options, cached-blocks steps)
CASES = {
    "step": (1, STEP, None),
    "optimize": (1, dict(max_lm_iterations=25, max_pcg_iterations=60,
                         cost_reduction_threshold=1e-8), None),
    "grid": (1, STEP, None),
    "rig2": (2, STEP, None),
    "rig3": (3, STEP, None),
    "multihost": (1, STEP, None),
    "direct": (1, dict(STEP, solver="schur_direct"), None),
    "direct_points": (1, dict(STEP, solver="schur_direct_points"), None),
    "scan": (1, STEP, 3),
    "bands": (2, dict(STEP, solver="schur"), None),
}
# The cases run by the reference package's sharding tests, held to its
# unsharded step too; ``direct*`` and ``scan`` are held to the port's
# unsharded step, which tests/test_torch_lm_step.py holds to the
# reference's.
REFERENCE_CASES = ("step", "optimize", "rig2", "rig3", "multihost")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _build():
    """The rig problem of ``test_sharding.py:116`` (seed 7, three cameras,
    40 points, 8 poses), perturbed (seed 8), and its first one and two
    cameras as smaller rigs: {cameras: (state, tables)}."""
    state_gt, obs, segments = torch_problems.make_problem(
        seed=7, n_points=40, n_poses=8, n_cameras=3)
    state0 = ba_harness.perturb_state(state_gt, seed=8)
    data = tuple(jds.pad_table(s, 8)
                 for s in jds.split_by_camera(obs, segments))
    out = {}
    for n in (1, 2, 3):
        st = type(state0)(**{**state0.__dict__,
                             "cam_q_rig": state0.cam_q_rig[:n],
                             "cam_t_rig": state0.cam_t_rig[:n],
                             "intrinsics": state0.intrinsics[:n]})
        out[n] = (st, data[:n])
    return out


def _port_case(name, state0, data):
    kind = "step" if name in ("rig2", "rig3") else name
    _, options, steps = CASES[name]
    case = {"kind": kind,
            "state": convert.ba_state(state0, device="cpu"),
            "data": tuple(convert.observation_table(s, device="cpu")
                          for s in data),
            "options": lm_pcg.BAOptions(**options),
            "steps": steps}
    if kind == "multihost":
        case["cut"] = [int(0.6 * s.count) for s in case["data"]]
    return case


def _unsharded(case):
    """The port's unsharded run of a case (as the worker runs it)."""
    state, data, opts = case["state"], case["data"], case["options"]
    kind = case["kind"]
    if kind.startswith("direct"):
        data = lm_pcg.maybe_grid_layout(data, state, opts)
    elif kind == "bands":
        data = grid_layout(data, state)
    warm = tuple(s.pixel for s in data)
    lam = torch.tensor(-1.0, dtype=torch.float64)
    if kind == "optimize":
        st, info = lm_pcg.optimize(state, None, None, opts, data=data)
        h = info["history"]
        return dict(accept=[e["accepted"] for e in h],
                    cg=[e["pcg_iterations"] for e in h],
                    cost=[e["cost"] for e in h], points=st.points,
                    grids=[m.grid for m in st.intrinsics],
                    median_px=median_error(st, data))
    if kind == "scan":
        st, _, _, outs = lm_pcg.make_lm_scan(opts, case["steps"])(
            state, warm, lam, data)
        return dict(accept=list(outs[0]), cg=list(outs[3]),
                    cost=list(outs[1]), new_cost=list(outs[2]),
                    points=st.points, grids=[m.grid for m in st.intrinsics])
    r = lm_pcg.make_lm_step(opts)(state, warm, lam, data)
    return dict(accept=[r[3]], cg=[r[6]], cost=[float(r[4])],
                new_cost=[float(r[5])], points=r[0].points,
                grids=[m.grid for m in r[0].intrinsics])


def _reference(name, state0, data):
    """The reference package's unsharded run (its float64 step on the CPU)."""
    import jax.numpy as jnp

    opts = jlm.BAOptions(**CASES[name][1])
    lam = jnp.asarray(-1.0, jnp.float64)
    if name == "optimize":
        st, info = jlm.optimize(state0, None, None, opts, data=data)
        h = info["history"]
        return dict(accept=[bool(e["accepted"]) for e in h],
                    cg=[int(e["pcg_iterations"]) for e in h],
                    cost=[float(e["cost"]) for e in h],
                    points=np.asarray(st.points))
    warm = tuple(s.pixel for s in data)
    r = jlm.make_lm_step(opts)(state0, warm, lam, data)
    return dict(accept=[bool(r[3])], cg=[int(r[6])], cost=[float(r[4])],
                new_cost=[float(r[5])], points=np.asarray(r[0].points))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(sharded results per rank, unsharded port results, reference
    results), each a dict by case name."""
    root = tmp_path_factory.mktemp("sharding")
    rigs = _build()
    cases = {name: _port_case(name, *rigs[CASES[name][0]]) for name in CASES}
    torch.save(cases, root / "cases.pt")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE), HERE]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_sharding_worker.py"),
         str(rank), "2", str(port), str(root / "cases.pt"),
         str(root / f"rank{rank}.pt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]
    try:
        # the unsharded references while the workers run
        unsharded = {name: _unsharded(case) for name, case in cases.items()}
        reference = {name: _reference(name, *rigs[CASES[name][0]])
                     for name in REFERENCE_CASES}
        # the grid case's unsharded step is the step case's
        reference["grid"] = reference["step"]
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return ranks, unsharded, reference


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_unsharded_and_reference(job, name):
    ranks, unsharded, reference = job
    r0, r1 = ranks[0][name], ranks[1][name]
    u = unsharded[name]
    ref = reference.get(name, u)
    # both ranks hold the same bits and made the same decisions
    assert r0["accept"] == r1["accept"] and r0["cg"] == r1["cg"]
    assert r0["cost"] == r1["cost"]
    assert torch.equal(r0["points"], r1["points"])
    for g0, g1 in zip(r0["grids"], r1["grids"]):
        assert torch.equal(g0, g1)
    # the decisions of the unsharded port step and of the reference
    assert r0["accept"] == u["accept"] == ref["accept"], (
        r0["accept"], u["accept"], ref["accept"])
    assert r0["cg"] == u["cg"] == ref["cg"], (r0["cg"], u["cg"], ref["cg"])
    assert _rel(r0["cost"][0], u["cost"][0]) < 1e-9
    assert _rel(r0["cost"][0], ref["cost"][0]) < 1e-9
    if "new_cost" in r0:
        for a, b, c in zip(r0["new_cost"], u["new_cost"], ref["new_cost"]):
            assert _rel(a, b) < 1e-3 and _rel(a, c) < 1e-3, (a, b, c)
    else:
        # converged (the reference's bar in test_sharding.py:55)
        assert r0["median_px"] < 1e-3 and u["median_px"] < 1e-3
    np.testing.assert_allclose(r0["points"].numpy(), u["points"].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(r0["points"].numpy(), np.asarray(ref["points"]),
                               rtol=0, atol=1e-5)
    if name != "optimize":  # the grid bar of test_sharding.py:75
        for g, gu in zip(r0["grids"], u["grids"]):
            np.testing.assert_allclose(g.numpy(), gu.numpy(), rtol=0,
                                       atol=1e-6)
    # every CG iteration summed across the ranks
    assert r0["collectives"].get("all_reduce", 0) >= sum(r0["cg"])


def test_shards_split_the_rows(job):
    """Flat tables split into equal row ranges, grid tables into bands of
    imagesets, per-process rows padded to the larger count."""
    ranks, _, _ = job
    for name in ("step", "rig3"):
        assert ranks[0][name]["rows"] == ranks[1][name]["rows"]
    mh = [ranks[r]["multihost"]["rows"] for r in range(2)]
    assert mh[0] == mh[1]
    assert ranks[0]["grid"]["collectives"].get("all_gather", 0) >= 1
    for name in ("direct", "direct_points"):
        rows = [ranks[r][name]["rows"][0] for r in range(2)]
        assert rows == [4 * 40, 4 * 40]
    assert [ranks[r]["bands"]["rows"] for r in range(2)] == [[4 * 40] * 2] * 2


def test_bands_take_the_grid_legs(job):
    """On tables sharded in bands of imagesets the reduced solve runs the
    grid passes on every rank (the right-hand side, each CG matvec and the
    back-substitution, once per camera); flat shards never reach them."""
    ranks, _, _ = job
    for r in range(2):
        bands = ranks[r]["bands"]
        assert bands["point_legs"] == 2 * (sum(bands["cg"]) + 1)
        assert ranks[r]["step"]["point_legs"] == 0
