from .gmres import gmres
from .direct import LUPreconditioner, lu_factor_dense, lu_solve_dense
from .preconditioners import (
    band_mask,
    JacobiPreconditioner,
    SORPreconditioner,
    SSORPreconditioner,
    BlockJacobiPreconditioner,
    build_preconditioner,
)
