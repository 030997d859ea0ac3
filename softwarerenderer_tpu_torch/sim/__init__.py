"""Simulation: the raycast physics query, the character controller, the
AI crowd and the particle system, stepped on the device (``sim.prng``
draws JAX's own random streams).  Exports what the JAX package's
``sim`` exports."""

from softwarerenderer_tpu_torch.sim.raycast import (  # noqa: F401
    FACE_MASK_IGNORE_BACKFACES,
    FACE_MASK_IGNORE_FRONTFACES,
    FACE_MASK_NONE,
    build_collision_world,
    raycast,
    raycast_batch,
)
from softwarerenderer_tpu_torch.sim.character import (  # noqa: F401
    character_step,
    default_character_params,
    initial_character_state,
)
from softwarerenderer_tpu_torch.sim.agents import (  # noqa: F401
    agents_step,
    build_waypoint_graph,
    default_brain_params,
    initial_agents_state,
    respawn_agent,
    scatter_waypoints_on_floor,
)
from softwarerenderer_tpu_torch.sim.particles import (  # noqa: F401
    default_emitter_params,
    initial_particle_state,
    particle_step,
    particle_uniforms,
    particles_mesh,
    soft_disc_texture,
)
