"""Checkpoint / resume for the scan engine's state
(``walnuts_tpu/utils/checkpoint.py``).

The state round-trips through a flat ``.npz`` whose twelve arrays are
the JAX ``SamplerState``'s leaves in its flatten order: ``q, lp, g, h,
delta``, the P2 estimator's ``npush, x, q, n, p``, ``err_facs`` and
``iter_n`` (int32).  A file written by the JAX package loads here and
resumes in the port, and the other way round.
"""

import numpy as np
import torch

from .p2 import P2State


def save_state(path: str, state) -> None:
    p2 = state.p2
    leaves = [state.q, state.lp, state.g, state.h, state.delta,
              p2.npush, p2.x, p2.q, p2.n, p2.p, state.err_facs]
    np.savez(path, *[x.cpu().numpy() for x in leaves],
             np.asarray(state.iter_n, np.int32))


def load_state(path: str):
    """The state saved at ``path``, as CPU tensors (``run_walnuts``
    moves a resume state to its device)."""
    from ..sampler.driver import SamplerState

    with np.load(path) as f:
        z = [f[k] for k in f.files]
    t = [torch.from_numpy(np.array(a)) for a in z[:11]]
    return SamplerState(
        q=t[0], lp=t[1], g=t[2], h=t[3], delta=t[4],
        p2=P2State(npush=t[5], x=t[6], q=t[7], n=t[8], p=t[9]),
        err_facs=t[10], iter_n=int(z[11]))
