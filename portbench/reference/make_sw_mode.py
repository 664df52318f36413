"""Remake ``data/stockwatson_mode.json``: the Stock-Watson posterior
mode that the stockwatson configuration starts its chains near.

Adam ascent on the plain reference's log density (this folder's
``stock_watson.py``, proper priors, the series in
``data/swdata.json``), 4000 steps at learning rate 0.02 from zeros, in
float32 on the CPU.  It writes the point and its log density.

    python3 portbench/reference/make_sw_mode.py
"""

import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from stock_watson import StockWatson  # noqa: E402

STEPS, LR = 4000, 0.02
OUT = HERE.parent / "data" / "stockwatson_mode.json"


def find_mode(target, steps=STEPS, lr=LR):
    q = torch.zeros(target.dim, dtype=torch.float32, requires_grad=True)
    opt = torch.optim.Adam([q], lr=lr)
    for _ in range(steps):
        _, g = target.logp_grad(q.detach()[None])
        q.grad = -g[0]
        opt.step()
    q = q.detach()
    return q, float(target.logp_grad(q[None])[0][0])


def main():
    torch.manual_seed(0)
    target = StockWatson(HERE.parent / "data" / "swdata.json", proper=True)
    q, lp = find_mode(target)
    OUT.write_text(json.dumps({
        "about": "Stock-Watson posterior mode: Adam, 4000 steps at lr 0.02 "
                 "from zeros, float32, on the CPU (reference/make_sw_mode.py)",
        "logp": lp, "q": [float(x) for x in q]}) + "\n")
    print(f"wrote {OUT}: log density {lp:.4f}")


if __name__ == "__main__":
    main()
