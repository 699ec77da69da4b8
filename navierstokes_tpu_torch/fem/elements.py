"""P1 tetrahedral element integration, batched over a leading element axis.

The closed-form element matrices of the reference (`src/integration.c`),
written for a batch of elements at once: every function takes tensors with
a leading axis of E elements (E may be 1).  DoF conventions as in the
reference: local velocity DoF I = 3*i + alpha for node i, component alpha;
M and A0 are 12x12, B is 4x12, D is 4x4.

Parity cross-references: tet_volum `src/integration.c:7-15`; tet_gradients
`:19-67`; tet_diameter `:70-81`; mass `:84-109`; diffusion `:112-164`;
divergence `:212-221`; pressure stabilization `:224-238`.
"""

from __future__ import annotations

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


def element_node_blocks(grad: torch.Tensor, vol: torch.Tensor,
                        h: torch.Tensor, dt: float, reynolds: float,
                        delta: float, *, terms: frozenset) -> torch.Tensor:
    """The (E, 4, 4, 4, 4) per-node-pair 4x4 blocks of a batch of elements.

    blocks[e, i, j] couples node i (rows) and node j (cols):
      [ vel-vel (3x3) | B^T col ]      vel-vel  = selected terms
      [ -B row        | D[i, j] ]      B^T col  = (vol/4) grad[i, a]
                                        B row    = (vol/4) grad[j, b]
    Ported terms: "diffusion", "mass_dt" and "mass_dt_bare" (the velocity
    mass alone, no B/B^T/D — the operator residual's M/dt u_old)."""
    unknown = set(terms) - {"diffusion", "mass_dt", "mass_dt_bare"}
    if unknown:
        raise NotImplementedError(
            f"element terms {sorted(unknown)} are not ported to "
            "navierstokes_tpu_torch yet (ROADMAP slice 2: assembly)")
    E = vol.shape[0]
    dtype, device = grad.dtype, grad.device
    vv = torch.zeros((E, 12, 12), dtype=dtype, device=device)
    if "diffusion" in terms:
        vv = vv + diffusion_matrix(grad, vol, reynolds)
    if "mass_dt" in terms or "mass_dt_bare" in terms:
        vv = vv + mass_matrix(vol) / dt

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
