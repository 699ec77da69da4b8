"""MatrixMarket coordinate files and the binary BCSR save: the JAX
package's `io/mtx.py`.

The reference writes `.mtx` through PETSc viewers (`save_matrix_mtx`,
`src/solve_newton.c:53-60`) for its standalone mpk benchmarks, which parse
them back (`mpk/SpM2V.cpp:815-852`).  `bench/create_mat.py` writes the
assembled operators here, byte for byte in the JAX package's format (the
`%%MatrixMarket` header, then `%d %d %.17g` lines), and `read_mtx` reads
any coordinate real matrix, general or symmetric.  Host numpy throughout:
a tensor's values are copied to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch.sparse.bcsr import BCSR4


def _host_values(m: BCSR4) -> np.ndarray:
    return m.values.detach().cpu().numpy()


def _scalar_coo(m: BCSR4) -> tuple:
    """The BCSR4 blocks as scalar COO in block-node order (4 node + comp)."""
    rows = m.row_ids().astype(np.int64)
    cols = m.indices.astype(np.int64)
    a = np.arange(4, dtype=np.int64)
    shape = (len(rows), 4, 4)
    r = np.broadcast_to(4 * rows[:, None, None] + a[None, :, None], shape)
    c = np.broadcast_to(4 * cols[:, None, None] + a[None, None, :], shape)
    return r.reshape(-1), c.reshape(-1), _host_values(m).reshape(-1)


def _write_mtx_coo(path: str, n: int, r, c, v) -> None:
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n} {n} {len(v)}\n")
        np.savetxt(f, np.column_stack([r + 1, c + 1, v]), fmt="%d %d %.17g")


def write_mtx(path: str, m: BCSR4) -> None:
    """A BCSR4 as a scalar MatrixMarket coordinate general real file in
    block-node DoF order, 4 node + component (the reference's
    `matrix_aijp` / `matrix_baij4` scalar content,
    `src/create_mat.c:412-484`)."""
    r, c, v = _scalar_coo(m)
    _write_mtx_coo(path, 4 * m.nb, r, c, v)


def write_mtx_by_component(path: str, m: BCSR4, nv: int) -> None:
    """A BCSR4 in the reference's ORDER_BY_COMPONENT scalar order: all u_x
    rows, then u_y, u_z, p (node + comp * nv, `src/create_mat.c:55-61`,
    output `:376-409`)."""
    if m.nb != nv:
        raise ValueError(f"matrix of {m.nb} block rows for {nv} nodes")
    r, c, v = _scalar_coo(m)
    _write_mtx_coo(path, 4 * nv, (r // 4) + (r % 4) * nv,
                   (c // 4) + (c % 4) * nv, v)


def read_mtx(path: str) -> tuple:
    """(n, rows, cols, vals): a MatrixMarket coordinate real file as COO,
    0-based, duplicates kept; a symmetric file's off-diagonal entries are
    given both ways."""
    with open(path, "r") as f:
        header = f.readline()
        if "coordinate" not in header:
            raise ValueError("only coordinate-format MatrixMarket supported")
        symmetric = "symmetric" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nr, _, _ = (int(t) for t in line.split())
        data = np.loadtxt(f, ndmin=2)
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = data[:, 2] if data.shape[1] > 2 else np.ones(len(rows))
    if symmetric:
        off = rows != cols
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, vals[off]])
    return nr, rows, cols, vals


def save_bcsr_npz(path: str, m: BCSR4) -> None:
    """Binary matrix save, the PETSc-binary `save_matrix` analog
    (`src/solve_newton.c:46-51`)."""
    np.savez_compressed(path, indptr=m.indptr, indices=m.indices,
                        values=_host_values(m))


def load_bcsr_npz(path: str, dtype: torch.dtype = None,
                  device="cpu") -> BCSR4:
    """Binary matrix load, the `MatLoad` analog (`src/main.c:58-68`): the
    values in `dtype` (as stored where None) on `device`."""
    with np.load(path) as d:
        values = torch.as_tensor(d["values"], device=device)
        if dtype is not None:
            values = values.to(dtype)
        return BCSR4(indptr=d["indptr"], indices=d["indices"], values=values)


def coo_to_csr(n: int, rows, cols, vals) -> tuple:
    """(indptr, cols, vals): COO to CSR with duplicates summed, the
    `COO2CSR` equivalent (`mpk/utils.cpp:97-127`)."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    keys = rows * n + cols
    uniq, first = np.unique(keys, return_index=True)
    summed = np.add.reduceat(vals, first)
    u_rows = (uniq // n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, u_rows + 1, 1)
    return np.cumsum(indptr), (uniq % n).astype(np.int64), summed
