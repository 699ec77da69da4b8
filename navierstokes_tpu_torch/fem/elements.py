"""P1 tetrahedral element integration, batched over a leading element axis.

The closed-form element matrices of the reference (`src/integration.c`),
written for a batch of elements at once: every function takes tensors with
a leading axis of E elements (E may be 1).  DoF conventions as in the
reference: local velocity DoF I = 3*i + alpha for node i, component alpha;
M and A0 are 12x12, B is 4x12, D is 4x4.

Parity cross-references: tet_volum `src/integration.c:7-15`; tet_gradients
`:19-67`; tet_diameter `:70-81`; mass `:84-109`; diffusion `:112-164`;
convection1 `:167-187`; convection2 `:190-209`; divergence `:212-221`;
pressure stabilization `:224-238`; exact convection Jacobian
`src/solve_newton.c:388-439`.  The nodal velocity field of an element is
`UL[e, alpha, i]` (component-major, the reference's `Uloc[3][4]`).
"""

from __future__ import annotations

from typing import Optional

import torch

# Voigt weights of the symmetric-gradient contraction (`integration.c:119`).
_VOIGT_WEIGHTS = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5)


def tet_volume(a: torch.Tensor) -> torch.Tensor:
    """Signed volume det(a1-a0, a2-a0, a3-a0) / 6 for vertices a (E, 4, 3)."""
    e = a[:, 1:] - a[:, :1]                     # (E, 3, 3) rows e1, e2, e3
    det = (
        e[:, 0, 0] * (e[:, 1, 1] * e[:, 2, 2] - e[:, 1, 2] * e[:, 2, 1])
        - e[:, 0, 1] * (e[:, 1, 0] * e[:, 2, 2] - e[:, 1, 2] * e[:, 2, 0])
        + e[:, 0, 2] * (e[:, 1, 0] * e[:, 2, 1] - e[:, 1, 1] * e[:, 2, 0])
    )
    return det / 6.0


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0],
    ], dim=1)


def tet_gradients(a: torch.Tensor) -> torch.Tensor:
    """P1 shape-function gradients (E, 4, 3).

    grad_i = (normal of the face opposite node i) / 6V with the reference's
    fixed vertex orderings.  The reference's sign convention is kept: these
    are the NEGATED gradients (a repo invariant), and every element matrix
    below is built to match it."""
    e = a[:, 1:] - a[:, :1]
    n = _cross(e[:, 1], e[:, 2])
    vol6 = (e[:, 0] * n).sum(-1, keepdim=True)            # 6V
    faces = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))
    grads = []
    for j, k, l in faces:
        v1 = a[:, k] - a[:, j]
        v2 = a[:, l] - a[:, j]
        grads.append(_cross(v1, v2) / vol6)
    return torch.stack(grads, dim=1)


def tet_diameter(a: torch.Tensor) -> torch.Tensor:
    """Longest edge length (element diameter h_K), (E,)."""
    diff = a[:, :, None, :] - a[:, None, :, :]          # (E, 4, 4, 3)
    d2 = (diff * diff).sum(-1)
    return torch.sqrt(d2.reshape(a.shape[0], 16).max(dim=1).values)


def mass_matrix_scalar(vol: torch.Tensor) -> torch.Tensor:
    """Scalar P1 mass matrix M4 (E, 4, 4): vol/10 diagonal, vol/20 off it."""
    base = torch.full((4, 4), 1.0 / 20.0, dtype=vol.dtype, device=vol.device)
    base = base + torch.eye(4, dtype=vol.dtype, device=vol.device) / 20.0
    return vol[:, None, None] * base


def mass_matrix(vol: torch.Tensor) -> torch.Tensor:
    """Vector mass matrix (E, 12, 12): M4 per velocity component."""
    m4 = mass_matrix_scalar(vol)
    eye3 = torch.eye(3, dtype=vol.dtype, device=vol.device)
    return torch.einsum("eij,ab->eiajb", m4, eye3).reshape(-1, 12, 12)


def strain_operator(grad: torch.Tensor) -> torch.Tensor:
    """Voigt strain operator S (E, 6, 12): S @ u_flat = voigt(eps(u))."""
    E = grad.shape[0]
    S = torch.zeros((E, 6, 4, 3), dtype=grad.dtype, device=grad.device)
    S[:, 0, :, 0] = grad[:, :, 0]
    S[:, 1, :, 1] = grad[:, :, 1]
    S[:, 2, :, 2] = grad[:, :, 2]
    S[:, 3, :, 0] = grad[:, :, 1]
    S[:, 3, :, 1] = grad[:, :, 0]
    S[:, 4, :, 0] = grad[:, :, 2]
    S[:, 4, :, 2] = grad[:, :, 0]
    S[:, 5, :, 1] = grad[:, :, 2]
    S[:, 5, :, 2] = grad[:, :, 1]
    return S.reshape(E, 6, 12)


def diffusion_matrix(grad: torch.Tensor, vol: torch.Tensor,
                     reynolds: float) -> torch.Tensor:
    """A0 (E, 12, 12) = (2/Re) * vol * S^T diag(w) S  (viscous term)."""
    S = strain_operator(grad)
    w = torch.tensor(_VOIGT_WEIGHTS, dtype=S.dtype, device=S.device)
    St_w = S.transpose(1, 2) * w
    return (2.0 / reynolds) * vol[:, None, None] * (St_w @ S)


def velocity_gradient(UL: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """G[e, alpha, beta] = d u_alpha / d x_beta for the nodal fields UL
    (E, 3, 4)."""
    return UL @ grad


def _kron_eye3(t: torch.Tensor) -> torch.Tensor:
    """(E, 4, 4) T -> (E, 12, 12) with [3i+a, 3j+b] = delta_ab T[i, j]."""
    eye3 = torch.eye(3, dtype=t.dtype, device=t.device)
    return torch.einsum("eij,ab->eiajb", t, eye3).reshape(-1, 12, 12)


def convection_matrix_linearized(UL: torch.Tensor, grad: torch.Tensor,
                                 vol: torch.Tensor) -> torch.Tensor:
    """A1 (E, 12, 12): A1[3i+a, 3j+b] = G[a, b] * M4[i, j]."""
    G = velocity_gradient(UL, grad)
    m4 = mass_matrix_scalar(vol)
    return torch.einsum("eij,eab->eiajb", m4, G).reshape(-1, 12, 12)


def convection_matrix_nonlinear(UL: torch.Tensor, grad: torch.Tensor,
                                vol: torch.Tensor) -> torch.Tensor:
    """A2 (E, 12, 12): A2[3i+a, 3j+b] = -delta_ab sum_m M4[i, m]
    (U[:, m] . grad_j)."""
    m4 = mass_matrix_scalar(vol)
    K = torch.einsum("edm,ejd->emj", UL, grad)     # K[m, j] = U[:,m].grad_j
    return -_kron_eye3(m4 @ K)


def convection_jacobian(UL: torch.Tensor, grad: torch.Tensor,
                        vol: torch.Tensor) -> tuple:
    """The exact Jacobian of the convection terms, (A1_jac, A2_jac), each
    (E, 12, 12):

    A1_jac[3i+a, 3k+b] = (vol/4) * G[a, b]              (any i, k)
    A2_jac[3i+a, 3k+b] = delta_ab * (vol/4) * (u_mean . grad_k)"""
    G = velocity_gradient(UL, grad)
    q = (vol / 4.0)[:, None, None]
    ones4 = torch.ones((4, 4), dtype=UL.dtype, device=UL.device)
    a1 = q * torch.einsum("ik,eab->eiakb", ones4, G).reshape(-1, 12, 12)
    c = grad @ UL.mean(dim=2)[:, :, None]          # (E, 4, 1): u_mean.grad_k
    a2 = q * _kron_eye3(c.transpose(1, 2).expand(-1, 4, 4))
    return a1, a2


def divergence_matrix(grad: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """B (E, 4, 12): B[i, 3j+a] = (vol/4) * grad[j, a]  (independent of i)."""
    row = (vol / 4.0)[:, None] * grad.reshape(-1, 12)
    return row[:, None, :].expand(-1, 4, 12)


def pressure_stabilization_matrix(grad: torch.Tensor, vol: torch.Tensor,
                                  h: torch.Tensor,
                                  delta: float) -> torch.Tensor:
    """D (E, 4, 4) = delta * h^2 * vol * grad_i . grad_j (Brezzi–Pitkäranta)."""
    return (delta * h * h * vol)[:, None, None] * (grad @ grad.transpose(1, 2))


def element_geometry(a: torch.Tensor):
    """(vol, grad, h) for a batch of elements a (E, 4, 3)."""
    return tet_volume(a), tet_gradients(a), tet_diameter(a)


ELEMENT_TERMS = frozenset({"diffusion", "mass_dt", "mass_dt_bare",
                           "convection", "convection_jacobian"})
CONVECTION_TERMS = frozenset({"convection", "convection_jacobian"})


def element_node_blocks(grad: torch.Tensor, vol: torch.Tensor,
                        h: torch.Tensor, dt: float, reynolds: float,
                        delta: float, *, terms: frozenset,
                        UL: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (E, 4, 4, 4, 4) per-node-pair 4x4 blocks of a batch of elements.

    blocks[e, i, j] couples node i (rows) and node j (cols):
      [ vel-vel (3x3) | B^T col ]      vel-vel  = selected terms
      [ -B row        | D[i, j] ]      B^T col  = (vol/4) grad[i, a]
                                        B row    = (vol/4) grad[j, b]
    `terms` is a subset of `ELEMENT_TERMS`: the Stokes operator is
    {"diffusion"} (`src/solve_newton.c:617-662`), J_linear {"mass_dt",
    "diffusion"} (`:520-563`), the nonlinear increment {"convection",
    "convection_jacobian"} (`:566-615`, B/B^T/D left at zero) and the full
    Newton Jacobian all four (`:448-517`); "mass_dt_bare" is the velocity
    mass alone, no B/B^T/D (the operator residual's M/dt u_old).  The
    convection terms read the nodal velocities `UL` (E, 3, 4)."""
    unknown = set(terms) - ELEMENT_TERMS
    if unknown:
        raise ValueError(f"unknown element terms {sorted(unknown)}; "
                         f"known: {sorted(ELEMENT_TERMS)}")
    if UL is None and terms & CONVECTION_TERMS:
        raise ValueError("the convection terms need the nodal velocities UL")
    E = vol.shape[0]
    dtype, device = grad.dtype, grad.device
    vv = torch.zeros((E, 12, 12), dtype=dtype, device=device)
    if "diffusion" in terms:
        vv = vv + diffusion_matrix(grad, vol, reynolds)
    if "mass_dt" in terms or "mass_dt_bare" in terms:
        vv = vv + mass_matrix(vol) / dt
    if "convection" in terms:
        vv = vv + convection_matrix_linearized(UL, grad, vol)
        vv = vv + convection_matrix_nonlinear(UL, grad, vol)
    if "convection_jacobian" in terms:
        a1j, a2j = convection_jacobian(UL, grad, vol)
        vv = vv + a1j + a2j

    vv4 = vv.reshape(E, 4, 3, 4, 3).permute(0, 1, 3, 2, 4)  # (e, i, j, a, b)
    blocks = torch.zeros((E, 4, 4, 4, 4), dtype=dtype, device=device)
    blocks[:, :, :, :3, :3] = vv4

    if "diffusion" in terms or "mass_dt" in terms:
        bt = (vol / 4.0)[:, None, None] * grad     # (e, i, a)
        blocks[:, :, :, :3, 3] = bt[:, :, None, :]
        blocks[:, :, :, 3, :3] = -bt[:, None, :, :]
        blocks[:, :, :, 3, 3] = pressure_stabilization_matrix(
            grad, vol, h, delta)
    return blocks


def element_residual(grad: torch.Tensor, vol: torch.Tensor, h: torch.Tensor,
                     UL: torch.Tensor, UL_old: torch.Tensor, PL: torch.Tensor,
                     dt: float, reynolds: float, delta: float) -> tuple:
    """Per-element residual contributions: F_v (E, 4, 3) by node and
    component, F_p (E, 4).

    F_v = (A0 + M/dt) u + (A1 + A2) u - (M/dt) u_old + B^T p
    F_p = -B u + D p
    (`compute_residual_optimized`, `src/solve_newton.c:284-386`), by direct
    contraction without the 12x12 matrices."""
    m4 = mass_matrix_scalar(vol)
    mass_term = m4 @ (UL - UL_old).transpose(1, 2) / dt      # (E, 4, 3)
    G = velocity_gradient(UL, grad)                           # (E, 3, 3)
    # weighted stress: G on the diagonal, the symmetric part off it
    eye = torch.eye(3, dtype=torch.bool, device=G.device)
    tau = torch.where(eye, G, 0.5 * (G + G.transpose(1, 2)))
    diff_term = (2.0 / reynolds) * vol[:, None, None] * (
        grad @ tau.transpose(1, 2))
    conv1 = m4 @ (G @ UL).transpose(1, 2)
    K = torch.einsum("edm,ejd->emj", UL, grad)
    conv2 = -((m4 @ K) @ UL.transpose(1, 2))
    pgrad = (vol / 4.0 * PL.sum(1))[:, None, None] * grad
    F_v = mass_term + diff_term + conv1 + conv2 + pgrad
    div = vol / 4.0 * (grad * UL.transpose(1, 2)).sum((1, 2))
    D = pressure_stabilization_matrix(grad, vol, h, delta)
    F_p = -div[:, None] + (D @ PL[:, :, None])[:, :, 0]
    return F_v, F_p
