"""A plain collocation BEM frame for the benchmark's correctness check.

Plain torch and numpy, in one dtype throughout (float64 for the reference,
float32 for its control), importing nothing of the program.  It solves one
frame of a rigid body or a torque-driven swimmer made of bilinear (Q1)
panels, in free space or beside a Blake no-slip wall, with the same
discretisation the program states:

- smooth panels by a tensor Gauss rule of `order` points a direction; own
  panels by the Duffy split rule aimed at the row's node (`singular_order`);
  where a gap between distinct components, or between the body and its wall
  image, is below the local panel diameter, each row's `near_panels`
  nearest panels by the rule of `order + promote_boost` (the program's
  quadrature auto-promotion);
- the bulk is formed panel by panel (every (row, panel, point) triple,
  summed into the panel's nodes), not node by node as the program's kernels
  do;
- the L2-projected normal, the null-space correction of V, the solid-angle
  correction of K, the tangential projectors, the monolithic system with
  its rigid rows and, for a swimmer, the motor-torque row and the gait
  rate's column;
- one dense solve (`torch.linalg.solve`), where the program iterates.

The formulas are frozen copies of the program's plain versions
(`bemstokes_tpu_torch/fem/quadrature.py`, `kernels/stokeslet.py`,
`kernels/images.py`, `physics/rigid.py`, `ops/corrections.py`,
`ops/monolithic.py`, `swimmer.py`, `physics/kinematics.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# --------------------------------------------------------------------------
# meshes and rules (host numpy)


def read_msh(path):
    """(vertices [n, 3], cells [Nc, 4] lexicographic) of a gmsh v2 quad
    surface mesh written by `stokesbench.gen.write_msh`."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = lines.index("$Nodes")
    n = int(lines[i + 1])
    nodes = np.array([ln.split() for ln in lines[i + 2 : i + 2 + n]], dtype=np.float64)
    ids = nodes[:, 0].astype(np.int64)
    verts = nodes[:, 1:4]
    j = lines.index("$Elements")
    nc = int(lines[j + 1])
    elems = np.array([ln.split() for ln in lines[j + 2 : j + 2 + nc]], dtype=np.int64)
    quads = elems[elems[:, 1] == 3]
    ntags = quads[:, 2]
    if np.any(ntags != ntags[0]):
        raise ValueError(f"{path}: mixed tag counts")
    ccw = quads[:, 3 + ntags[0] :]
    pos = np.full(ids.max() + 1, -1, dtype=np.int64)
    pos[ids] = np.arange(n)
    return verts, pos[ccw[:, [0, 1, 3, 2]]]


def gauss_1d(order):
    x, w = np.polynomial.legendre.leggauss(order)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_quad(order):
    x, w = gauss_1d(order)
    px, py = np.meshgrid(x, x, indexing="xy")
    wx, wy = np.meshgrid(w, w, indexing="xy")
    return np.stack([px.ravel(), py.ravel()], axis=-1), (wx * wy).ravel()


def duffy_rule(order, sp):
    """The unit square split into the non-degenerate triangles (sp, c_k,
    c_k+1), each with a Duffy-mapped Gauss rule whose Jacobian ~ r cancels
    the 1/R singularity at sp."""
    x, w = gauss_1d(order)
    u, v = np.meshgrid(x, x, indexing="xy")
    wu, wv = np.meshgrid(w, w, indexing="xy")
    tri = np.stack([(u * (1.0 - v)).ravel(), (u * v).ravel()], axis=-1)
    tw = (wu * wv * u).ravel()
    corners = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    pts, wts = [], []
    for k in range(4):
        a, b = corners[k], corners[(k + 1) % 4]
        e1, e2 = a - sp, b - sp
        area2 = abs(e1[0] * e2[1] - e1[1] * e2[0])
        if area2 < 1e-14:
            continue
        pts.append(sp[None, :] + tri[:, :1] * e1[None, :] + tri[:, 1:2] * e2[None, :])
        wts.append(tw * area2)
    return np.concatenate(pts), np.concatenate(wts)


#: Q1's nodes on the unit square, lexicographic
Q1_NODES = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])


def q1_values(pts):
    x, y = pts[..., 0], pts[..., 1]
    return np.stack([(1 - x) * (1 - y), x * (1 - y), (1 - x) * y, x * y], axis=-1)


def q1_grads(pts):
    x, y = pts[..., 0], pts[..., 1]
    gx = np.stack([-(1 - y), 1 - y, -y, y], axis=-1)
    gy = np.stack([-(1 - x), -x, 1 - x, x], axis=-1)
    return np.stack([gx, gy], axis=-1)


def component_labels(cells, n):
    """Connected-component label of each cell (through shared vertices)."""
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for c in cells:
        r = find(c[0])
        for v in c[1:]:
            parent[find(v)] = r
    roots = np.array([find(c[0]) for c in cells])
    return np.unique(roots, return_inverse=True)[1].reshape(-1)


def cell_diameters(verts, cells):
    p = verts[cells]
    return np.max(
        [np.linalg.norm(p[:, i] - p[:, j], axis=-1) for i in range(4) for j in range(i + 1, 4)], axis=0
    )


def promoted(verts, cells, wall):
    """Whether the program's auto-promotion fires on the mesh of its first
    frame: a gap between distinct components, or twice the height above
    the image wall, below the largest diameter of the panels at the closest
    vertices."""
    diam = cell_diameters(verts, cells)
    labels = component_labels(cells, len(verts))
    vlab = np.full(len(verts), -1)
    vlab[cells.ravel()] = np.repeat(labels, 4)
    cands = []
    comps = np.unique(labels)
    best = (np.inf, -1, -1)
    for a in comps:
        for b in comps:
            if b <= a:
                continue
            ia, ib = np.nonzero(vlab == a)[0], np.nonzero(vlab == b)[0]
            for s in range(0, len(ia), 1024):
                d = np.linalg.norm(verts[ia[s : s + 1024], None] - verts[None, ib], axis=-1)
                k = np.unravel_index(np.argmin(d), d.shape)
                if d[k] < best[0]:
                    best = (d[k], ia[s + k[0]], ib[k[1]])
    if np.isfinite(best[0]):
        touch = np.any(cells == best[1], axis=1) | np.any(cells == best[2], axis=1)
        cands.append((best[0], diam[touch].max()))
    if wall is not None:
        axis, position = wall
        h = np.abs(verts[:, axis] - position)
        v = int(np.argmin(h))
        touch = np.any(cells == v, axis=1)
        cands.append((2.0 * h[v], diam[touch].max()))
    return any(gap < d for gap, d in cands)


# --------------------------------------------------------------------------
# Green's functions (torch, any batch shape)


def _ipow(x, k):
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def free_space(p, n):
    """(G, W.n) of the free-space Stokeslet and stresslet, viscosity 1."""
    r2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]
    invR = torch.rsqrt(r2)
    pp = p[..., :, None] * p[..., None, :]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    G = (pp * (invR**3)[..., None, None] + eye * invR[..., None, None]) / (8.0 * math.pi)
    pn = p[..., 0] * n[..., 0] + p[..., 1] * n[..., 1] + p[..., 2] * n[..., 2]
    Wn = (-3.0 / (4.0 * math.pi)) * pp * (pn * _ipow(invR, 5))[..., None, None]
    return G, Wn


def _G3(p):
    R = torch.sqrt(torch.sum(p * p, dim=-1))
    pp = p[..., :, None] * p[..., None, :]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    return pp / _ipow(R, 3)[..., None, None] + eye / R[..., None, None]


def no_slip(p, pI, n, axis):
    """(G, W.n) of the Blake no-slip wall system; pI = x_q - image(x_i)."""
    dt, dev = p.dtype, p.device
    eye = torch.eye(3, dtype=dt, device=dev)
    e_w = torch.zeros(3, dtype=dt, device=dev)
    e_w[axis] = 1.0
    s = torch.ones(3, dtype=dt, device=dev)
    s[axis] = -1.0  # -1 on the wall row
    h0 = 0.5 * (pI[..., axis] - p[..., axis])[..., None, None]
    R = torch.sqrt(torch.sum(p * p, dim=-1))[..., None, None]
    RI = torch.sqrt(torch.sum(pI * pI, dim=-1))[..., None, None]
    pIpI = pI[..., :, None] * pI[..., None, :]
    pI_w = pI[..., axis][..., None, None]
    # single layer
    D = -3.0 * pIpI / _ipow(RI, 5) + eye / _ipow(RI, 3)
    SD = (e_w[:, None] * pI[..., None, :] - e_w[None, :] * pI[..., :, None]) / _ipow(RI, 3)
    corr = -2.0 * h0 * h0 * D + 2.0 * h0 * (pI_w * D + SD)
    G = (_G3(p) - _G3(pI) + (-s)[:, None] * corr) / (8.0 * math.pi)
    # double layer, contracted with n
    pn = torch.sum(p * n, dim=-1)[..., None, None]
    pIn = torch.sum(pI * n, dim=-1)[..., None, None]
    pIi, pIj = pI[..., :, None], pI[..., None, :]
    ni, nj = n[..., :, None], n[..., None, :]
    base = -p[..., :, None] * p[..., None, :] * pn / _ipow(R, 5) + pIi * pIj * pIn / _ipow(RI, 5)
    diag = eye * (pI**2 * n)[..., :, None]
    Tn = -(ni * pIj + diag) / _ipow(RI, 5) + 5.0 * pIi * pIj * pIn / _ipow(RI, 7)
    Un = (nj * pIi * pI_w - e_w[:, None] * pIj * pIn) / _ipow(RI, 5)
    Wn = base + s[:, None] * (2.0 * h0 * h0 * Tn - 2.0 * h0 * (pI_w * Tn + Un))
    return G, Wn * (3.0 / (4.0 * math.pi))


def image(x, axis, position):
    y = x.clone()
    y[..., axis] = 2.0 * position - x[..., axis]
    return y


# --------------------------------------------------------------------------
# the frame


class Frame:
    """The static part of a frame: connectivity, rules and the physics that
    a configuration states.  `wall` is (axis, position) of a Blake no-slip
    wall, or None for free space."""

    def __init__(self, cells, n, *, order, singular_order, near_panels, promote_boost, promote,
                 wall=None, dtype=torch.float64, device="cpu"):
        self.cells = np.asarray(cells, dtype=np.int64)
        self.n = n
        self.wall = wall
        self.dt = dtype
        self.dev = torch.device(device)
        self.promote = promote
        self.near_panels = near_panels

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.dev)

        far = gauss_quad(order)
        self.far = tuple(t(a) for a in (far[1], q1_values(far[0]), q1_grads(far[0])))
        hi = gauss_quad(order + promote_boost)
        self.hi = tuple(t(a) for a in (hi[1], q1_values(hi[0]), q1_grads(hi[0])))
        rules = [duffy_rule(singular_order, sp) for sp in Q1_NODES]
        pts = np.stack([r[0] for r in rules])  # [4, qs, 2]
        self.sing = (t(np.stack([r[1] for r in rules])), t(q1_values(pts)), t(q1_grads(pts)))
        self.cells_t = torch.as_tensor(self.cells, device=self.dev)

    # ---- geometry
    def panels(self, euler, rule):
        """(xq [Nc, q, 3], unit normals, JxW [Nc, q]) on `rule`."""
        w, phi, dphi = rule
        ec = euler[self.cells_t]  # [Nc, 4, 3]
        xq = torch.einsum("ql,cld->cqd", phi, ec)
        J = torch.einsum("qlk,cld->cqdk", dphi, ec)
        nrm = torch.linalg.cross(J[..., 0], J[..., 1], dim=-1)
        jac = torch.sqrt(torch.sum(nrm * nrm, dim=-1))
        return xq, nrm / jac[..., None], jac * w[None, :]

    def green(self, p, xi_img_p, normals):
        if self.wall is None:
            return free_space(p, normals)
        return no_slip(p, xi_img_p, normals, self.wall[0])

    def _pairs(self, xi, xq, normals):
        """(G, W.n) for rows xi [T, 3] against points xq [..., q, 3]."""
        shape = (xi.shape[0],) + (1,) * (xq.ndim - 1) + (3,)
        p = xq[None] - xi.reshape(shape)
        pI = None
        if self.wall is not None:
            pI = xq[None] - image(xi, *self.wall).reshape(shape)
        return self.green(p, pI, normals[None])

    # ---- operators
    def operators(self, euler, block_bytes=2 * 1024**3):
        """Dense (V, K) [3n, 3n], component-blocked."""
        n, cells = self.n, self.cells_t
        Nc = cells.shape[0]
        xq, normals, jxw = self.panels(euler, self.far)
        wphi = jxw[:, :, None] * self.far[1][None]  # [Nc, q, 4]
        q = xq.shape[1]
        V = torch.zeros((3, n, 3, n), dtype=self.dt, device=self.dev)
        K = torch.zeros_like(V)
        T = max(1, int(block_bytes // (Nc * q * 9 * euler.element_size() * 6)))
        cols = cells.reshape(-1)
        for t0 in range(0, n, T):
            rows = torch.arange(t0, min(n, t0 + T), device=self.dev)
            G, Wn = self._pairs(euler[rows], xq, normals)  # [T, Nc, q, 3, 3]
            keep = (~torch.any(cells[None] == rows[:, None, None], dim=-1)).to(self.dt)  # [T, Nc]
            Vs = torch.einsum("tcqab,cql,tc->clatb", G, wphi, keep).reshape(Nc * 4, 3, -1, 3)
            Ks = torch.einsum("tcqab,cql,tc->clatb", Wn, wphi, keep).reshape(Nc * 4, 3, -1, 3)
            del G, Wn
            Vn = torch.zeros((n,) + Vs.shape[1:], dtype=self.dt, device=self.dev).index_add_(0, cols, Vs)
            Kn = torch.zeros_like(Vn).index_add_(0, cols, Ks)
            V[:, t0 : t0 + len(rows)] = Vn.permute(1, 2, 3, 0)
            K[:, t0 : t0 + len(rows)] = -Kn.permute(1, 2, 3, 0)
            del Vs, Ks, Vn, Kn
        V, K = V.reshape(3 * n, 3 * n), K.reshape(3 * n, 3 * n)
        self._singular(euler, V, K)
        if self.promote:
            self._near(euler, V, K)
        return V, K

    def _scatter(self, M, rows, cols_nodes, vals):
        """M[(a, row), (b, col)] += vals[..., a, b, l] over the panel's nodes."""
        n = self.n
        ar = torch.arange(3, device=self.dev)
        ri = (ar[:, None] * n + rows[None, :]).T  # [R, 3]
        ci = ar[None, None, :, None] * n + cols_nodes[:, :, None, :]  # [R, P, 3, 4]
        shape = vals.shape  # [R, P, 3, 3, 4]
        M.index_put_(
            (ri[:, None, :, None, None].expand(shape).reshape(-1), ci[:, :, None, :, :].expand(shape).reshape(-1)),
            vals.reshape(-1),
            accumulate=True,
        )

    def _local(self, euler_cells, xi, rule):
        """Local (V, K) [R, P, 3, 3, 4] of rows xi [R, 3] on the panels
        euler_cells [R, P, 4, 3] by `rule`."""
        w, phi, dphi = rule
        xq = torch.einsum("ql,rpld->rpqd", phi, euler_cells)
        J = torch.einsum("qlk,rpld->rpqdk", dphi, euler_cells)
        nrm = torch.linalg.cross(J[..., 0], J[..., 1], dim=-1)
        jac = torch.sqrt(torch.sum(nrm * nrm, dim=-1))
        normals = nrm / jac[..., None]
        p = xq - xi[:, None, None, :]
        pI = None if self.wall is None else xq - image(xi, *self.wall)[:, None, None, :]
        G, Wn = self.green(p, pI, normals)
        jxw = jac * w
        return (
            torch.einsum("rpqab,rpq,ql->rpabl", G, jxw, phi),
            -torch.einsum("rpqab,rpq,ql->rpabl", Wn, jxw, phi),
        )

    def _singular(self, euler, V, K):
        """Own panels by the Duffy rule of the row's local node."""
        rows, cols, Vl, Kl = self.singular_blocks(euler)
        self._scatter(V, rows, cols, Vl)
        self._scatter(K, rows, cols, Kl)

    def singular_blocks(self, euler):
        """(rows [R], cols [R, 1, 4], V and K blocks [R, 1, 3, 3, 4]) of each
        (panel, local node) pair: the row of the node against its own panel
        by the Duffy rule of that node."""
        w, phi, dphi = self.sing  # [4, qs], [4, qs, 4], [4, qs, 4, 2]
        ec = euler[self.cells_t]  # [Nc, 4, 3]
        xq = torch.einsum("lqm,cmd->clqd", phi, ec)
        J = torch.einsum("lqmk,cmd->clqdk", dphi, ec)
        nrm = torch.linalg.cross(J[..., 0], J[..., 1], dim=-1)
        jac = torch.sqrt(torch.sum(nrm * nrm, dim=-1))
        normals = nrm / jac[..., None]
        xi = ec  # Q1: the row of local node l is the panel's vertex l
        p = xq - xi[:, :, None, :]
        pI = None if self.wall is None else xq - image(xi, *self.wall)[:, :, None, :]
        G, Wn = self.green(p, pI, normals)
        jxw = jac * w[None]
        Vl = torch.einsum("clqab,clq,lqm->clabm", G, jxw, phi)
        Kl = -torch.einsum("clqab,clq,lqm->clabm", Wn, jxw, phi)
        Nc = ec.shape[0]
        rows = self.cells_t.reshape(-1)  # (c, l) -> its node
        cols = self.cells_t[:, None, :].expand(Nc, 4, 4).reshape(-1, 1, 4)
        return rows, cols, Vl.reshape(Nc * 4, 1, 3, 3, 4), Kl.reshape(Nc * 4, 1, 3, 3, 4)

    def _near(self, euler, V, K):
        """Each row's `near_panels` nearest panels (by centre, ties to the
        lower index), own panels left out, raised from the far rule to the
        near rule."""
        for rows, cols, dV, dK in self.near_blocks(euler):
            self._scatter(V, rows, cols, dV)
            self._scatter(K, rows, cols, dK)

    def near_blocks(self, euler, RC=1024):
        """Yield (rows [R], cols [R, P, 4], V and K deltas [R, P, 3, 3, 4]) of
        `_near`, RC rows at a time."""
        ec = euler[self.cells_t]
        centers = ec.mean(dim=1)
        Kn = min(self.near_panels, ec.shape[0])
        for r0 in range(0, self.n, RC):
            rows = torch.arange(r0, min(self.n, r0 + RC), device=self.dev)
            xi = euler[rows]
            d2 = torch.sum((xi[:, None, :] - centers[None]) ** 2, dim=-1)
            near = torch.sort(d2, dim=1, stable=True).indices[:, :Kn]
            cols = self.cells_t[near]  # [R, Kn, 4]
            keep = (~torch.any(cols == rows[:, None, None], dim=-1)).to(self.dt)[..., None, None, None]
            Vh, Kh = self._local(ec[near], xi, self.hi)
            Vf, Kf = self._local(ec[near], xi, self.far)
            yield rows, cols, (Vh - Vf) * keep, (Kh - Kf) * keep

    # ---- mass, normal, rigid modes
    def mass(self, v, jxw):
        """The consistent mass M v, v [n, D]."""
        phi = self.far[1]
        vq = torch.einsum("ql,clD->cqD", phi, v[self.cells_t])
        rc = torch.einsum("ql,cqD,cq->clD", phi, vq, jxw)
        return torch.zeros_like(v).index_add_(0, self.cells_t.reshape(-1), rc.reshape(-1, v.shape[1]))

    def normal(self, normals_q, jxw):
        """The L2-projected unit normal [n, 3]: CG on the mass matrix, Jacobi
        (lumped) preconditioned, as the program states it."""
        n, phi = self.n, self.far[1]
        rhs = torch.zeros((n, 3), dtype=self.dt, device=self.dev).index_add_(
            0, self.cells_t.reshape(-1), torch.einsum("ql,cqd,cq->cld", phi, normals_q, jxw).reshape(-1, 3)
        )
        diag = torch.zeros(n, dtype=self.dt, device=self.dev).index_add_(
            0, self.cells_t.reshape(-1), torch.einsum("ql,cq->cl", phi, jxw).reshape(-1)
        )

        def mv(x):
            return self.mass(x.reshape(n, 3), jxw).reshape(-1)

        def pre(r):
            return (r.reshape(n, 3) / diag[:, None]).reshape(-1)

        b = rhs.reshape(-1)
        x = pre(b)
        r = b - mv(x)
        z = pre(r)
        p = z
        rz = torch.dot(r, z)
        for _ in range(500):
            if float(torch.linalg.vector_norm(r)) <= 1e-12:
                break
            Ap = mv(p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = pre(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        sol = x.reshape(n, 3)
        norm = torch.linalg.vector_norm(sol, dim=-1, keepdim=True)
        return sol / torch.where(norm == 0, torch.ones_like(norm), norm)

    def solve(self, euler, *, grid, imposed_component=0, rotation=None, flagellum=None,
              motor_torque=-2.0, pole="Origin"):
        """Solve the frame at node positions euler [n, 3].

        grid "ImposedForce": a unit force along `imposed_component`, no
        torque.  grid "Real" with `flagellum` (a 0/1 mask [n]): the swimmer
        under the imposed motor torque, its gait rate an unknown, the
        flagellum's rotation mode about the body's x axis under `rotation`.
        Returns the forces [n, 3], the rigid velocities [6] and, for the
        swimmer, the gait rate and the transmitted motor torque."""
        n, dt, dev = self.n, self.dt, self.dev
        euler = torch.as_tensor(euler, dtype=dt, device=dev)
        s = self.system(euler, grid=grid, imposed_component=imposed_component, rotation=rotation,
                        flagellum=flagellum, motor_torque=motor_torque, pole=pole)
        nf, Mnf, l2g = s["nf"], s["Mnf"], s["l2g"]
        V, K = self.operators(euler)
        V.add_(torch.outer(nf - V @ nf, Mnf / l2g))
        # solid angle: each node's 3 x 3 diagonal block so that K e_b = e_b
        C = torch.stack([K[:, b * n : (b + 1) * n].sum(dim=1) for b in range(3)], dim=-1).reshape(3, n, 3)
        i = torch.arange(n, device=dev)
        for a in range(3):
            for b in range(3):
                K[a * n + i, b * n + i] += -C[a, :, b] + (1.0 if a == b else 0.0)

        def PKP(v):
            return s["P"](s["P"](v) @ K.T)

        tmp_N = PKP(s["N"])  # [6, 3n]
        dn = 3 * n
        torque = "mode" in s
        size = dn + 6 + (1 if torque else 0)
        A = torch.zeros((size, size), dtype=dt, device=dev)
        A[:dn, :dn] = V
        del V
        A[:dn, dn : dn + 6] = -tmp_N.T
        A[dn : dn + 6, :dn] = s["N_dual"]
        if torque:
            A[:dn, -1] = -PKP(s["mode"])
            A[-1, :dn] = s["dual"]
        rhs = torch.zeros(size, dtype=dt, device=dev)
        rhs[dn:] = s["rhs"]
        del K
        x = torch.linalg.solve(A, rhs)
        forces = x[:dn].reshape(3, n).T
        out = dict(forces=forces, velocities=x[dn : dn + 6])
        if torque:
            out["omega"] = x[-1]
            out["torque"] = torch.dot(s["dual"], x[:dn])
        return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in out.items()}

    def system(self, euler, *, grid, imposed_component=0, rotation=None, flagellum=None,
               motor_torque=-2.0, pole="Origin"):
        """What the frame's monolithic system holds besides V and K, at node
        positions euler (a tensor [n, 3]), component-blocked [3n]: the
        L2-projected normal `nf`, its mass `Mnf` and their product `l2g`, the
        projection `P` off the normal, the rigid modes `N` [6, 3n] about the
        pole and their duals `N_dual`, for the swimmer the flagellum's
        rotation mode `mode` and its dual `dual`, and the right-hand side of
        the rows below the surface rows, `rhs` [6] or [7] (arguments as
        `solve`)."""
        n, dt, dev = self.n, self.dt, self.dev
        xq, normals_q, jxw = self.panels(euler, self.far)
        nv = self.normal(normals_q, jxw)
        Mn = self.mass(nv, jxw)
        nf, Mnf = nv.T.reshape(-1), Mn.T.reshape(-1)
        l2g = torch.sum(Mn * nv)
        eye = torch.eye(3, dtype=dt, device=dev)
        r = euler
        if pole == "Baricenter":
            r = euler - torch.einsum("cq,cqd->d", jxw, xq) / torch.sum(jxw)
        modes = [eye[a].expand(n, 3) for a in range(3)]
        modes += [torch.linalg.cross(eye[a].expand(n, 3), r, dim=-1) for a in range(3)]
        N = torch.stack(modes)  # [6, n, 3]: translations, rotations about the pole
        N_dual = torch.stack([self.mass(m, jxw) for m in N])

        def P(v):
            return v - nf * ((v @ Mnf) / l2g)[..., None]

        flat = lambda v: v.transpose(-1, -2).reshape(*v.shape[:-2], -1)  # noqa: E731
        out = dict(nf=nf, Mnf=Mnf, l2g=l2g, P=P, N=flat(N), N_dual=flat(N_dual))
        torque = grid == "Real" and flagellum is not None
        rhs = torch.zeros(6 + (1 if torque else 0), dtype=dt, device=dev)
        if torque:
            Rm = torch.as_tensor(rotation, dtype=dt, device=dev)
            body = euler @ Rm
            ex = torch.zeros_like(body)
            ex[:, 0] = 1.0
            mode = (torch.linalg.cross(ex, body, dim=-1) @ Rm.T) * torch.as_tensor(
                flagellum, dtype=dt, device=dev
            )[:, None]
            out.update(mode=flat(mode), dual=flat(self.mass(mode, jxw)))
            rhs[-1] = motor_torque
        elif grid == "ImposedForce":
            rhs[imposed_component] = 1.0
        else:
            raise ValueError(f"grid {grid!r} without a flagellum is not in the reference")
        out["rhs"] = rhs
        return out


# --------------------------------------------------------------------------
# the frame loop's host state


def advance_rotation(Rm, omega, dt):
    """The body rotation after one forward-Euler quaternion step."""
    Rm = np.asarray(Rm, dtype=np.float64)
    w = np.sqrt(1.0 + Rm[0, 0] + Rm[1, 1] + Rm[2, 2]) / 2.0
    q = np.array([w, 0.25 * (Rm[2, 1] - Rm[1, 2]) / w, 0.25 * (Rm[0, 2] - Rm[2, 0]) / w, 0.25 * (Rm[1, 0] - Rm[0, 1]) / w])
    q = q / np.linalg.norm(q)
    ox, oy, oz = (float(o) for o in omega)
    qd = 0.5 * np.array(
        [
            -q[1] * ox - q[2] * oy - q[3] * oz,
            q[0] * ox + q[3] * oy - q[2] * oz,
            -q[3] * ox + q[0] * oy + q[1] * oz,
            q[2] * ox - q[1] * oy + q[0] * oz,
        ]
    )
    qn = q + dt * qd
    w, x, y, z = qn / np.linalg.norm(qn)
    return np.array(
        [
            [1 - 2 * (z * z + y * y), -2 * w * z + 2 * x * y, 2 * w * y + 2 * x * z],
            [2 * w * z + 2 * x * y, 1 - 2 * (z * z + x * x), -2 * w * x + 2 * z * y],
            [-2 * w * y + 2 * x * z, 2 * w * x + 2 * z * y, 1 - 2 * (x * x + y * y)],
        ]
    )


def spherical_head(euler):
    """Nodes with x <= 0 moved onto the ellipsoid (1.6, 0.8, 0.8) about
    (-1.6, 0, 0), along their direction from its centre."""
    c = np.array([-1.6, 0.0, 0.0])
    rel = euler - c
    nrm = np.linalg.norm(rel, axis=1, keepdims=True)
    mapped = rel / np.where(nrm == 0, 1.0, nrm) * np.array([1.6, 0.8, 0.8]) + c
    return np.where((euler[:, 0] <= 0.0)[:, None], mapped, euler)


def snap_sphere(verts, center, radius):
    rel = verts - np.asarray(center)
    return np.asarray(center) + rel / np.linalg.norm(rel, axis=-1, keepdims=True) * radius
