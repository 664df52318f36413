"""Post-hoc MCMC diagnostics: batched multi-chain ESS and Rhat."""

from .ess import ess, rhat, split_rhat

__all__ = ["ess", "rhat", "split_rhat"]
