"""User hook registry (counterpart of dynearthsol_tpu/hooks.py).

surface_process_option 101 in the reference dispatches to
``custom_surface_processes`` (bc.cxx:1667-1831 case 101), a user-edited
C++ function.  Here it is a registered Python callable
``fn(sim, dt_elapsed) -> dh_top`` returning the surface increment over
``sim.ctx.surf.top_nodes`` (same order), or None; the CLI calls it at every
step's wake and applies it with ``Simulation.apply_host_surface_dh``.
"""

from __future__ import annotations

_custom_surface_process = None


def set_custom_surface_process(fn) -> None:
    """Register (or clear, with None) the option-101 surface hook."""
    global _custom_surface_process
    _custom_surface_process = fn


def get_custom_surface_process():
    return _custom_surface_process
