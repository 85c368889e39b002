from .stokeslet import stokeslet_G, stresslet_W, hypersingular_L, contract_normal, stokeslet_G_Wn
from .helpers import impose_G_as_velocity, impose_G_as_trace
from .images import (
    image_point,
    free_surface_G,
    free_surface_W,
    no_slip_wall_G,
    no_slip_wall_W,
    no_slip_wall_singular_GW,
    free_surface_G_Wn,
    no_slip_wall_Wn,
)

__all__ = [
    "stokeslet_G",
    "stresslet_W",
    "hypersingular_L",
    "contract_normal",
    "stokeslet_G_Wn",
    "impose_G_as_velocity",
    "impose_G_as_trace",
    "image_point",
    "free_surface_G",
    "free_surface_W",
    "no_slip_wall_G",
    "no_slip_wall_W",
    "no_slip_wall_singular_GW",
    "free_surface_G_Wn",
    "no_slip_wall_Wn",
]
