"""One rank of the two-process gloo job of ``tests/test_torch_sharding.py``.

    python torch_sharding_worker.py <rank> <world size> <port> <cases.pt> <out.pt>

Loads the cases the test built (port states and tables, float64 on the
CPU), joins a gloo group on ``127.0.0.1:<port>``, runs every case on its
shard of the tables and saves what it got (per case: the costs, the
accept decisions and CG counts, the new state's points and grids, the
collectives called, the calls of the Schur solve's grid pass A) to
``out.pt``.
"""

import sys

import torch

from camera_calibration_torch.ba import lm_pcg, schur_cuda
from camera_calibration_torch.ba.dataset import to_grid_layout
from camera_calibration_torch.calibrate import observation_reprojection_errors
from camera_calibration_torch.parallel import distributed, sharding


def _state_arrays(st):
    return {"points": st.points, "grids": [m.grid for m in st.intrinsics]}


def grid_layout(data, state):
    """Every table in (M, P) grid layout, whatever its fill."""
    m, p = state.rig_q_global.shape[0], state.points.shape[0]
    return tuple(to_grid_layout(seg, m, p) for seg in data)


# calls of the Schur solve's grid passes (pass A), by case
leg_calls = {"point_leg": 0}


def _counting(fn):
    def counted(*args, **kwargs):
        leg_calls["point_leg"] += 1
        return fn(*args, **kwargs)
    return counted


def median_error(state, data):
    """Median reprojection error of all valid observations (pixels)."""
    errs = torch.cat(observation_reprojection_errors(state, data))
    return float(errs[torch.isfinite(errs)].median())


def run_case(case, rank):
    kind = case["kind"]
    state = distributed.replicate_multihost(case["state"])
    data = case["data"]
    opts = case["options"]
    if kind == "multihost":
        # this rank's own rows, split unevenly
        cut = case["cut"]
        local = tuple(lm_pcg._slice_table(seg, slice(0, c) if rank == 0
                                          else slice(c, seg.count))
                      for seg, c in zip(data, cut))
        sh = distributed.shard_observations_multihost(local)
    else:
        if kind.startswith("direct"):
            data = lm_pcg.maybe_grid_layout(data, state, opts)
        elif kind == "bands":
            data = grid_layout(data, state)
        sh = sharding.shard_observations(data)
        if kind == "grid":
            sh = sharding.shard_grid_blocks(sh)
    sharding.reset_collectives()
    leg_calls["point_leg"] = 0
    warm = tuple(seg.pixel for seg in sh)
    lam = torch.tensor(-1.0, dtype=torch.float64)
    out = {"rows": [seg.count for seg in sh]}
    if kind == "optimize":
        st, info = lm_pcg.optimize(state, None, None, opts, data=sh)
        hist = info["history"]
        out.update(accept=[h["accepted"] for h in hist],
                   cg=[h["pcg_iterations"] for h in hist],
                   cost=[h["cost"] for h in hist],
                   median_px=median_error(st, data))
    elif kind == "scan":
        st, _, _, outs = lm_pcg.make_lm_scan(opts, case["steps"])(
            state, warm, lam, sh)
        out.update(accept=list(outs[0]), cg=list(outs[3]),
                   cost=list(outs[1]), new_cost=list(outs[2]))
    else:
        r = lm_pcg.make_lm_step(opts)(state, warm, lam, sh)
        st = r[0]
        out.update(accept=[r[3]], cg=[r[6]], cost=[float(r[4])],
                   new_cost=[float(r[5])])
    out.update(_state_arrays(st))
    out["collectives"] = dict(sharding.collectives)
    out["point_legs"] = leg_calls["point_leg"]
    return out


def main():
    rank, world, port, cases_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    schur_cuda.point_leg = _counting(schur_cuda.point_leg)
    assert distributed.initialize(f"127.0.0.1:{port}", world, rank,
                                  device="cpu")
    cases = torch.load(cases_path, weights_only=False)
    results = {name: run_case(case, rank)
               for name, case in cases.items()}
    torch.save(results, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
