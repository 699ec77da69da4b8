"""Checkpoint and resume: the solver state (u, u_old, delta_u, the step)
in one `.npz`, with a fingerprint of the config.  `load_checkpoint` checks
the fingerprint, so a run cannot resume under other physics or numerics.

The fingerprint is the JAX package's: sha256 of the config as JSON
(`dataclasses.asdict`, keys sorted).  This package's config is field for
field the JAX one, so a checkpoint written by either package resumes in
the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np


def config_fingerprint(cfg) -> str:
    payload = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def save_checkpoint(path: str, *, cfg, step: int, u, u_old,
                    delta_u=None) -> None:
    """Write the state after step `step` (arrays: numpy or tensors)."""
    u = _host(u)
    np.savez(path, fingerprint=np.array(config_fingerprint(cfg)),
             step=np.array(step, dtype=np.int64), u=u, u_old=_host(u_old),
             delta_u=np.zeros_like(u) if delta_u is None else _host(delta_u))


def load_checkpoint(path: str, *, cfg=None) -> tuple:
    """(step, u, u_old, delta_u) as numpy arrays.  With `cfg`, raise unless
    the checkpoint was written under the same config."""
    with np.load(path, allow_pickle=False) as data:
        if cfg is not None:
            want, got = config_fingerprint(cfg), str(data["fingerprint"])
            if got != want:
                raise ValueError(
                    f"checkpoint config fingerprint {got} != current {want}; "
                    "refusing to resume with different physics/numerics")
        return (int(data["step"]), data["u"], data["u_old"],
                data["delta_u"])
