from .surface_mesh import SurfaceMesh
from .io import read_mesh, read_msh, read_inp, read_vtk
from .dofs import ScalarSpace, build_scalar_space
from .factories import create_sphere, create_cube, create_wall

__all__ = [
    "SurfaceMesh",
    "read_mesh",
    "read_msh",
    "read_inp",
    "read_vtk",
    "ScalarSpace",
    "build_scalar_space",
    "create_sphere",
    "create_cube",
    "create_wall",
]
