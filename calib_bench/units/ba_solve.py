"""Unit of work: one bundle-adjustment solve through the pipeline's entry,
``camera_calibration_torch.calibrate.run_ba``.

Set-up makes the deployment on the device (``synth.make_problem``), the
program's observation table in (view × corner) grid layout, and the pool of
start states of the deployment, each the truth with noise
(``synth.perturb``; all from the configuration's ``deployment_seed``).
Unit i solves from start (seed + i) mod the pool, with the traffic's
iteration budget and stop threshold and ``CalibrateOptions`` otherwise.

The check (:meth:`Job.compare`) judges what the timed solves returned: the
final states of solves drawn from the seed, and the cost each solve
reported.  The float64 reference (``reference.camera``) works out again the
cost of each final state against the observations (``cost_gap``: the
reported cost's relative gap from it), the cost of the true state
(``cost_ratio``: the final cost over the truth's), and the cost drop that
one more Gauss–Newton step would still make from the final state
(``step_gain``, over its cost: a solve that stopped short of the optimum
reads more).

:meth:`Job.use_control` puts the control in the program's place: the
reference in TF32, whose answer is the true state held in TF32 and whose
reported cost is worked out in TF32.  Its solves go through the same
:meth:`Job.unit` and :meth:`Job.compare`.
"""

from __future__ import annotations

import torch

from calib_bench import synth
from calib_bench.reference import camera as ref


def port_state(s):
    """The program's BAState (float32) of a reference state dict."""
    from camera_calibration_torch.ba.state import BAState
    from camera_calibration_torch.models import central_generic as cg
    from camera_calibration_torch.models import noncentral_generic as ncg

    dev = s["points"].device
    w, h = s["width"], s["height"]
    area = dict(width=w, height=h, calibration_min_x=0, calibration_min_y=0,
                calibration_max_x=w - 1, calibration_max_y=h - 1)
    if s.get("origins") is None:
        model = cg.CentralGenericModel(grid=s["directions"].float(), **area)
    else:
        model = ncg.NoncentralGenericModel(
            direction_grid=s["directions"].float(),
            point_grid=s["origins"].float(), **area)
    return BAState(
        rig_q_global=s["rig_q"].float(), rig_t_global=s["rig_t"].float(),
        cam_q_rig=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev),
        cam_t_rig=torch.zeros((1, 3), device=dev),
        points=s["points"].float(), intrinsics=(model,))


def reference_state(st, width, height):
    """The reference's float64 state dict of a program BAState (read only
    to judge it)."""
    model = st.intrinsics[0]
    grid = getattr(model, "grid", None)
    if grid is None:
        grid = model.direction_grid
    return {"rig_q": st.rig_q_global.double(),
            "rig_t": st.rig_t_global.double(),
            "cam_q": st.cam_q_rig[0].double(),
            "cam_t": st.cam_t_rig[0].double(),
            "points": st.points.double(), "directions": grid.double(),
            "origins": (model.point_grid.double()
                        if hasattr(model, "point_grid") else None),
            "width": width, "height": height}


class Job:
    def __init__(self, cfg, mix, seed, device):
        from camera_calibration_torch import calibrate
        from camera_calibration_torch.ba.dataset import ObservationTable

        self.cfg, self.mix, self.seed = cfg, mix, seed
        self._run_ba = calibrate.run_ba
        self.options = calibrate.CalibrateOptions()
        truth, pixel, kept = synth.make_problem(cfg, device)
        self.truth, self.pixel, self.kept = truth, pixel, kept
        m, p = truth["rig_q"].shape[0], truth["points"].shape[0]
        self.table = ObservationTable(
            imageset=torch.arange(m, device=device).repeat_interleave(p),
            camera=torch.zeros(m * p, dtype=torch.int64, device=device),
            point=torch.arange(p, device=device).repeat(m),
            pixel=pixel.float(), valid=kept, grid_shape=(m, p))
        gen = synth.generator(cfg["deployment_seed"], 1, device)
        pert = cfg["perturbation"]
        self.warm_start = port_state(synth.perturb(truth, pert, gen))
        self.starts = [port_state(synth.perturb(truth, pert, gen))
                       for _ in range(int(mix["starts"]))]
        self.solves = []

    def shapes(self):
        """What the work counts need: the window kernels' call shape, with
        the rows the deployment observes (the kept slots) as N: the program
        passes every slot of the (view × corner) layout, and the rows it
        never observed are no work the solve needs."""
        d = self.truth["directions"]
        return {"window": {"n": int(self.kept.sum()), "gh": d.shape[0],
                           "gw": d.shape[1],
                           "k": 2 if self.truth["origins"] is None else 5,
                           "elem_bytes": 4}}

    def _solve(self, start, iterations):
        return self._run_ba(start, (self.table,), iterations,
                            float(self.mix["cost_reduction_threshold"]),
                            self.options)

    def warm(self):
        self._solve(self.warm_start, int(self.mix["warm_iterations"]))

    def unit(self):
        start = (self.seed + len(self.solves)) % len(self.starts)
        st, info = self._solve(self.starts[start],
                               int(self.mix["max_iterations"]))
        hist = info["history"]
        self.solves.append({
            "start": start, "state": st, "final_cost": info["final_cost"],
            "lm_iterations": len(hist),
            "pcg_iterations": sum(int(e["pcg_iterations"]) for e in hist)})

    def stats(self, first=0):
        """The counters of the solves from the ``first``-th on."""
        solves = self.solves[first:]
        return {"units": len(solves),
                "lm_iterations": sum(s["lm_iterations"] for s in solves),
                "pcg_iterations": sum(s["pcg_iterations"] for s in solves),
                "lm_iterations_by_solve": [s["lm_iterations"]
                                           for s in solves]}

    def release(self):
        self.starts = []
        self.warm_start = None

    def compare(self, draw):
        """{number: value} of the solves ``draw`` picks (the worst of
        them), and what each solve read."""
        w, h = self.truth["width"], self.truth["height"]
        truth = ref.evaluate(self.truth, self.pixel, self.kept)
        picked = draw(len(self.solves), int(self.mix["checked_solves"]))
        numbers = {"cost_gap": [], "cost_ratio": [], "step_gain": []}
        notes = []
        for i in picked:
            s = self.solves[i]
            mine = s["final_cost"]
            e = ref.evaluate(reference_state(s["state"], w, h), self.pixel,
                             self.kept, gain=True)
            numbers["cost_gap"].append(
                abs(mine - e["cost"]) / e["cost"] if mine is not None
                else float("inf"))
            numbers["cost_ratio"].append(e["cost"] / truth["cost"])
            numbers["step_gain"].append(e["gain"])
            notes.append(f"solve {i}: reported cost {mine}, reference "
                         f"{e['cost']} over {e['rows']} rows (rms "
                         f"{e['rms']:.6f} px), step gain {e['gain']!r}, truth "
                         f"{truth['cost']} (rms {truth['rms']:.6f} px), "
                         f"{s['lm_iterations']} LM iterations from start "
                         f"{s['start']}")
        return {k: max(v) for k, v in numbers.items()}, notes

    def use_control(self):
        """Put the control in the program's place (see the module's
        text)."""
        def control_run_ba(_start, _data, _iterations, _threshold, _options):
            st = ref.round_state(self.truth, ref.round_tf32)
            reported = ref.evaluate(st, self.pixel, self.kept,
                                    precision="tf32")["cost"]
            return port_state(st), {"final_cost": reported,
                                    "history": [{"pcg_iterations": 0}]}

        self._run_ba = control_run_ba


def setup(cfg, mix, seed, device):
    return Job(cfg, mix, seed, device)
