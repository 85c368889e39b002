"""The reference's judgement of a frame loop whose operators no single card
holds: the solve is judged by the residual of the monolithic system at the
candidate's own solution, with V and K applied a block of rows at a time.

The geometry and the state are judged exactly as `loop.py` judges them.
The solve (the candidate's tractions, six rigid velocities and, for a
swimmer, gait rate) is put into the reference's monolithic system at the
reference's own geometry, and its rows are compared with the right-hand
side:

- `residual`: the surface rows, ||A x - b||_inf over ||V f||_inf (V with
  its null-space correction).  Their right-hand side is zero (a towed body,
  a swimmer under its motor torque), so it cannot be the scale;
- `balance`: the rigid rows and the torque row, ||A x - b||_inf over the
  imposed force or motor torque, ||b||_inf of those rows.

V f and K P(w) are formed over all 3n rows in blocks of rows: each row
block's Green's functions against every panel's quadrature points,
contracted at once with the columns' values there, so neither operator
is ever held; the own panels (Duffy rule), the near pairs when the
quadrature promotes, V's null-space term (from V nf) and K's solid-angle
diagonal (from each row's sum, K e_b) are added as `bem.Frame.solve` adds
them.  The projection P off the normal needs every row, so the residual is
over all rows, not a sample.

The control is the candidate's tractions, velocities and gait rate rounded
to float32: no float32 computation can carry less error than that
rounding, so a limit below the control's reading fails every float32
computation.  Nothing here imports the program."""

from __future__ import annotations

import numpy as np
import torch

from . import loop


def numbers(problem):
    """The names of the numbers `judge` gives for a configuration."""
    return {"geometry", "state", "residual", "balance"}


class Reference(loop.Reference):
    """The streamed reference of one configuration's frame loop.  Its
    operators are applied in row blocks whose Green's functions hold about
    `block_bytes` (`bem.Frame.operators`' rule); `blocks` and
    `block_rows` keep the count and the largest block of the last apply."""

    def __init__(self, problem, dtype=torch.float64, device="cpu", block_bytes=2 * 1024**3):
        super().__init__(problem, dtype=dtype, device=device)
        self.block_bytes = block_bytes
        self.blocks = self.block_rows = 0

    def apply(self, euler, xV, xK):
        """(V xV, K xK) [3n, m] of the frame's V and K before their
        null-space and solid-angle corrections, xV [3n, mV] and xK [3n, mK]
        component-blocked, over all rows in row blocks."""
        fr = self.frame
        n, cells = fr.n, fr.cells_t
        euler = torch.as_tensor(euler, dtype=self.dtype, device=fr.dev)
        xq, normals, jxw = fr.panels(euler, fr.far)
        wphi = jxw[:, :, None] * fr.far[1][None]  # [Nc, q, 4]
        Nc, q = xq.shape[:2]
        # each column's values at the quadrature points, weighted: [Nc, q, 3, m]
        XV = torch.einsum("cql,bclm->cqbm", wphi, xV.reshape(3, n, -1)[:, cells])
        XK = torch.einsum("cql,bclm->cqbm", wphi, xK.reshape(3, n, -1)[:, cells])
        yV = torch.zeros((3, n, XV.shape[-1]), dtype=self.dtype, device=fr.dev)
        yK = torch.zeros((3, n, XK.shape[-1]), dtype=self.dtype, device=fr.dev)
        T = max(1, int(self.block_bytes // (Nc * q * 9 * euler.element_size() * 6)))
        self.blocks, self.block_rows = 0, min(T, n)
        for t0 in range(0, n, T):
            rows = torch.arange(t0, min(n, t0 + T), device=fr.dev)
            G, Wn = fr._pairs(euler[rows], xq, normals)  # [T, Nc, q, 3, 3]
            keep = (~torch.any(cells[None] == rows[:, None, None], dim=-1)).to(self.dtype)
            keep = keep[:, :, None, None, None]
            yV[:, rows] = torch.einsum("tcqab,cqbm->atm", G.mul_(keep), XV)
            yK[:, rows] = -torch.einsum("tcqab,cqbm->atm", Wn.mul_(keep), XK)
            del G, Wn
            self.blocks += 1
        xV3, xK3 = xV.reshape(3, n, -1), xK.reshape(3, n, -1)
        blocks = [fr.singular_blocks(euler)]
        if fr.promote:
            blocks = [blocks[0], *fr.near_blocks(euler)]
        for rows, cols, dV, dK in blocks:
            yV.index_add_(1, rows, torch.einsum("rpabl,brplm->arm", dV, xV3[:, cols]))
            yK.index_add_(1, rows, torch.einsum("rpabl,brplm->arm", dK, xK3[:, cols]))
        return yV.reshape(3 * n, -1), yK.reshape(3 * n, -1)

    def residual(self, euler, rotation, cand):
        """{"residual", "balance"} of the candidate's solution in the
        reference's system at node positions `euler`."""
        n, dt, dev = self.frame.n, self.dtype, self.frame.dev
        s = self.frame.system(torch.as_tensor(euler, dtype=dt, device=dev),
                              **self.physics(np.asarray(rotation, dtype=self.np_dtype)))
        f = torch.as_tensor(np.asarray(cand["forces"]).T.reshape(-1), dtype=dt, device=dev)
        U = torch.as_tensor(np.asarray(cand["velocities"]), dtype=dt, device=dev)
        y = U @ s["N"]
        if "mode" in s:
            omega = torch.as_tensor(float(cand["omega"]), dtype=dt, device=dev)
            y = y + omega * s["mode"]
        Py = s["P"](y)
        ones = torch.zeros((3 * n, 3), dtype=dt, device=dev)
        for b in range(3):
            ones[b * n : (b + 1) * n, b] = 1.0
        yV, yK = self.apply(euler, torch.stack([f, s["nf"]], dim=1), torch.cat([Py[:, None], ones], dim=1))
        Vf = yV[:, 0] + (s["nf"] - yV[:, 1]) * ((s["Mnf"] @ f) / s["l2g"])
        # K's solid-angle diagonal: each node's 3 x 3 block so that K e_b = e_b
        C = yK[:, 1:].reshape(3, n, 3)  # [a, i, b]: row (a, i)'s sum over block b
        diag = torch.eye(3, dtype=dt, device=dev)[:, None, :] - C
        KPy = yK[:, 0] + torch.einsum("aib,bi->ai", diag, Py.reshape(3, n)).reshape(-1)
        surface = Vf - s["P"](KPy)
        tail = s["N_dual"] @ f
        if "mode" in s:
            tail = torch.cat([tail, (s["dual"] @ f)[None]])
        rest = tail - s["rhs"]
        return dict(
            residual=float(surface.abs().max() / Vf.abs().max()),
            balance=float(rest.abs().max() / s["rhs"].abs().max()),
        )


def expected(ref, k, rotation, displacements):
    """The reference's node positions of frame k from the state the
    candidate carried into it."""
    return ref.euler(k, rotation, displacements)


def judge(ref, euler, rotation, displacements, cand):
    """The numbers that judge a candidate's frame (a dict as
    `loop.Reference.candidate` returns) against the reference's node
    positions `euler` of that frame (`expected`), from the state (rotation,
    displacements) the candidate carried into the frame."""
    R, disp = ref.advance(rotation, displacements, cand["velocities"])
    gaps = dict(
        geometry=loop._rel(cand["euler"], euler),
        state=max(loop._rel(cand["rotation"], R), loop._rel(cand["displacements"], disp)),
    )
    gaps.update(ref.residual(euler, rotation, cand))
    return gaps


def rounded(cand):
    """The candidate with its tractions, velocities and gait rate rounded to
    float32."""
    out = dict(cand)
    for key in ("forces", "velocities", "omega"):
        if key in out:
            out[key] = np.asarray(out[key], dtype=np.float32).astype(np.float64)
    return out


class Control:
    """The control: the program's own frame, its solution rounded to
    float32 (`rounded`)."""

    def __init__(self, problem, device):
        pass

    def candidate(self, k, rotation, displacements, program):
        return rounded(program)
