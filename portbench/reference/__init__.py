"""Plain references of what the benchmark runs: the WALNUTS engine under
fixed tuning (:mod:`.walnuts`), each target's log density, gradient,
summaries and exact draws (one module per target, named as the target
is in a configuration file) and the pooled warmup's consensus
(:mod:`.consensus`).  Plain
torch and numpy only; nothing here imports the program under test."""
