"""The small twin of `sphere_wall-contact` beside the other cells' twins:
the sphere on create_sphere(2) 1.02 radii from the wall, where its
quadrature's auto-promotion fires and the near delta runs."""

from .twins import SEED, TWINS as _TWINS

CONTACT = "sphere_wall-contact"

#: every cell's twin, the contact cell's among them
TWINS = {**_TWINS, CONTACT: (dict(refinements=2), {})}

__all__ = ["CONTACT", "SEED", "TWINS"]
