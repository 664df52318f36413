"""Post-hoc MCMC diagnostics: batched multi-chain ESS and Rhat, and the
reference's validation statistics; ``gather_chains`` joins the draws of
chains split over ranks, ``gather_blocks`` the blocks of a ``(chains,
dim)`` mesh."""

from .ess import (ess, ess_per_grad, gather_blocks, gather_chains, rhat,
                  split_rhat)
from .stats import index_stat_histogram, qq_normal

__all__ = ["ess", "ess_per_grad", "rhat", "split_rhat", "qq_normal",
           "index_stat_histogram", "gather_chains", "gather_blocks"]
