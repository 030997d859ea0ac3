"""Simulation: the raycast physics query (``sim.raycast``) and the
particle billboards (``sim.particles``)."""
