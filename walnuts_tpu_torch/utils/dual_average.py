"""Nesterov-style dual averaging of a log-scale tuning parameter
(``walnuts_tpu/utils/dual_average.py``).

Batched and functional: the state is a tuple of tensors of the batch
shape, and ``da_observe`` returns a new one.  The fixed-orbit
multinomial sampler drives its ``delta`` with it toward an ESS-fraction
target (``isokinetic/samplers.py:107-109,259-263``).
"""

import math
from typing import NamedTuple

import torch


class DualAverageState(NamedTuple):
    log_est: torch.Tensor
    log_est_avg: torch.Tensor
    grad_avg: torch.Tensor
    obs_count: torch.Tensor
    log_step_offset: torch.Tensor
    target: torch.Tensor


def da_init(init_par, target, batch_shape=(), dtype=torch.float32,
            device=None):
    """A fresh state at ``init_par`` (natural scale) for every element of
    ``batch_shape``, steering toward ``target``."""
    batch_shape = tuple(batch_shape)
    log0 = torch.log(torch.as_tensor(init_par, dtype=dtype,
                                     device=device)).expand(batch_shape)
    zeros = torch.zeros(batch_shape, dtype=dtype, device=device)
    return DualAverageState(
        log_est=log0.clone(),
        log_est_avg=log0.clone(),
        grad_avg=zeros,
        obs_count=zeros,
        log_step_offset=math.log(10.0) + log0,
        target=torch.as_tensor(target, dtype=dtype,
                               device=device).expand(batch_shape).clone(),
    )


def da_observe(state: DualAverageState, target_draw, mask=None,
               obs_count_offset=10.0, learn_rate=0.05, decay_rate=0.75):
    """Fold one observation ``target_draw`` in; where ``mask`` (a bool
    tensor of the batch shape) is false the state is kept."""
    count = state.obs_count + 1.0
    prop = 1.0 / (count + obs_count_offset)
    grad_avg = ((1.0 - prop) * state.grad_avg
                + prop * (state.target - target_draw))
    log_est = state.log_step_offset - torch.sqrt(count) / learn_rate * grad_avg
    prop2 = count ** (-decay_rate)
    log_est_avg = prop2 * log_est + (1.0 - prop2) * state.log_est_avg
    new = state._replace(log_est=log_est, log_est_avg=log_est_avg,
                         grad_avg=grad_avg, obs_count=count)
    if mask is None:
        return new
    return DualAverageState(*(
        torch.where(mask, a, b) if f in ("log_est", "log_est_avg",
                                         "grad_avg", "obs_count") else b
        for f, a, b in zip(state._fields, new, state)))


def da_par(state: DualAverageState):
    """Current iterate-averaged parameter estimate (natural scale)."""
    return torch.exp(state.log_est_avg)
