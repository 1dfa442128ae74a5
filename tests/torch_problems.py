"""The reference's projection compiled once, for the port's tests.

``protocol.project_points`` runs eagerly where it is called outside a
jitted function (``ba_harness.make_problem`` projects each pose's points
so, and so do the reference visualizer's hooks): a loop of Gauss-Newton
iterations dispatched op by op, about a second a call on the CPU.  Under
``jax.jit`` the same function takes milliseconds; on the problems of the
port's tests it gives the same bits.
"""

import contextlib
from unittest import mock

import jax

import ba_harness
from camera_calibration_tpu.models import protocol


@contextlib.contextmanager
def jitted_projection():
    """``protocol.project_points`` under ``jax.jit`` inside the block."""
    fast = jax.jit(protocol.project_points,
                   static_argnames=("max_iterations",))
    with mock.patch.object(protocol, "project_points", fast):
        yield


def make_problem(**kw):
    """``ba_harness.make_problem(**kw)``, projecting under ``jax.jit``."""
    with jitted_projection():
        return ba_harness.make_problem(**kw)
