"""Render the reference's four figure families from the port's committed
experiment artifacts (the port of ``examples/make_figs.py``).

No experiment is re-run here: the figures are the human-readable
rendering of the JSONs the port's harnesses wrote on the card, which sit
beside this module.  It never reads the JAX package's artifacts.

Reference figure sources regenerated:

* ``plotsGaussESS.py:67,78`` -> ``fig_gauss_ess.png``: ESS per 1000
  gradient evaluations against dimension, log-log, with the
  ``d^{-1/4}`` theory guide (``out_gaussian_ess.json``);
* ``plotsGaussTransient.py:33-36`` -> ``fig_gauss_transient.png``: the
  fraction of chains inside the 95% chi-square band of ``|q|^2`` per
  iteration, per dimension (``out_gaussian_transient.json``);
* ``plotsFunnel.py:103-122`` -> ``fig_funnel_transient.png``: the omega
  = -30 deep-neck transient, the native C++ chains' recovery traces and
  the micro step-size floor the halving search reaches
  (``out_funnel_transient_native_s{1,2}.json``).  The scan engine's
  curve is drawn where the port has its artifact
  (``out_funnel_transient.json``, ``funnel_transient --engine scan``);
  at 51-71 h per chain on the card it has none yet, and the title says
  so;
* ``plotsSW.py:60-141`` -> ``fig_stock_watson_bands.png``: the
  Stock-Watson posterior quantile bands (time-averaged q10/q50/q90 of
  sigma, z, x, tau) across samplers (``out_stock_watson.json``).

The palette and layout are the JAX script's: one hue per entity in
every figure, one y-axis per panel.  matplotlib is imported here only;
nothing on the card's path needs it.

Usage: ``python -m walnuts_tpu_torch.examples.make_figs`` (writes
``walnuts_tpu_torch/examples/figs/*.png``).
"""

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FIGS = HERE / "figs"

# fixed categorical assignment, one entity = one hue everywhere
C_R2P = "#2a78d6"      # walnuts (R2P)      - blue
C_D = "#eb6834"        # walnuts (D)        - orange
C_NUTS = "#1baf7a"     # NUTS               - aqua
C_NATIVE = "#eda100"   # native C++ engine  - yellow
C_SCAN = "#4a3aa7"     # scan engine        - violet
INK = "#0b0b0b"
INK2 = "#52514e"
SURFACE = "#fcfcfb"

TAGS = ("walnuts_r2p", "walnuts_d", "nuts")
SAMPLER_COLOR = {"walnuts_r2p": C_R2P, "walnuts_d": C_D, "nuts": C_NUTS}
SAMPLER_LABEL = {"walnuts_r2p": "WALNUTS (R2P)",
                 "walnuts_d": "WALNUTS (D)", "nuts": "NUTS"}
ESS_FNS = ("ess_per_1000_grad_q0", "ess_per_1000_grad_sumsq")
SCAN_WAITS = "the scan arm waits on ROADMAP queue 2 item 2"


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _load(src, name):
    return json.loads((Path(src) / name).read_text())


def _style(ax, title):
    ax.set_facecolor(SURFACE)
    ax.set_title(title, color=INK, fontsize=10, loc="left")
    ax.grid(True, color="#e6e4df", linewidth=0.6, zorder=0)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(INK2)
    ax.tick_params(colors=INK2, labelsize=8)


def _save(plt, fig, dst, name):
    fig.tight_layout()
    fig.savefig(Path(dst) / name, facecolor=SURFACE)
    plt.close(fig)


def fig_gauss_ess(src=HERE, dst=FIGS):
    """The ESS-scaling figure; returns its series ``{functional: {tag:
    [y per row]}}`` and the dimensions."""
    plt = _plt()
    d = _load(src, "out_gaussian_ess.json")
    rows = d["rows"]
    dims = np.array([r["d"] for r in rows], float)
    series = {fn: {tag: [r[tag][fn] for r in rows] for tag in TAGS}
              for fn in ESS_FNS}
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    for ax, fn, fname in zip(axes, ESS_FNS,
                             ("functional q[0]", "functional sum q^2")):
        for tag in TAGS:
            ax.loglog(dims, np.array(series[fn][tag], float), "-o",
                      color=SAMPLER_COLOR[tag], label=SAMPLER_LABEL[tag],
                      linewidth=1.8, markersize=4, zorder=3)
        # d^{-1/4} theory guide anchored at the first WALNUTS-D point
        y0 = rows[0]["walnuts_d"][fn]
        ax.loglog(dims, y0 * (dims / dims[0]) ** -0.25, "--", color=INK2,
                  linewidth=1.2, zorder=2, label=r"$d^{-1/4}$ guide")
        _style(ax, f"ESS per 1000 grad evals - {fname}")
        ax.set_xlabel("dimension d", color=INK2, fontsize=9)
    axes[0].set_ylabel("ESS / 1000 grads", color=INK2, fontsize=9)
    axes[0].legend(frameon=False, fontsize=8, labelcolor=INK)
    s = d["summary"]
    fig.suptitle(
        "Gaussian ESS scaling on the card (out_gaussian_ess.json; fit "
        f"slope {s['fit_slope_log_ess_vs_log_d']:.3f} ± "
        f"{s['fit_slope_stderr']:.3f} vs theory -0.25)",
        fontsize=10, color=INK)
    _save(plt, fig, dst, "fig_gauss_ess.png")
    return dims.tolist(), series


def fig_gauss_transient(src=HERE, dst=FIGS):
    plt = _plt()
    rows = _load(src, "out_gaussian_transient.json")["rows"]
    n = len(rows)
    fig, axes = plt.subplots(1, n, figsize=(2.6 * n, 3.2), dpi=150,
                             sharey=True)
    axes = np.atleast_1d(axes)
    fig.patch.set_facecolor(SURFACE)
    for ax, r in zip(axes, rows):
        for tag in TAGS:
            y = np.array(r[tag]["frac_inside_by_iter"], float)
            ax.plot(np.arange(len(y)), y, color=SAMPLER_COLOR[tag],
                    linewidth=1.8, label=SAMPLER_LABEL[tag], zorder=3)
        ax.axhline(0.95, color=INK2, linestyle="--", linewidth=1.0, zorder=2)
        _style(ax, f"d = {r['d']}")
        ax.set_xlabel("iteration", color=INK2, fontsize=9)
        ax.set_ylim(0, 1.05)
    axes[0].set_ylabel("fraction of chains inside the\n95% chi-square band",
                       color=INK2, fontsize=9)
    axes[0].legend(frameon=False, fontsize=8, labelcolor=INK,
                   loc="lower right")
    fig.suptitle("Gaussian transient on the card: convergence of |q|^2 "
                 "into its chi-square band (out_gaussian_transient.json)",
                 fontsize=10, color=INK)
    _save(plt, fig, dst, "fig_gauss_transient.png")


def fig_funnel_transient(src=HERE, dst=FIGS):
    """The funnel transient; returns whether the scan arm was drawn."""
    plt = _plt()
    native = [_load(src, f"out_funnel_transient_native_s{k}.json")
              for k in (1, 2)]
    scan_path = Path(src) / "out_funnel_transient.json"
    scan = json.loads(scan_path.read_text()) if scan_path.exists() else None
    fig, (ax, ax2) = plt.subplots(
        2, 1, figsize=(7, 5.4), dpi=150, sharex=True,
        gridspec_kw={"height_ratios": [2.2, 1.0]})
    fig.patch.set_facecolor(SURFACE)
    for i, ch in enumerate(native):
        tr = np.array(ch["omega_trace"], float)[:400]
        ax.plot(np.arange(len(tr)), tr, color=C_NATIVE, linewidth=1.4,
                alpha=0.8 if i else 1.0,
                label="native C++ chains (seeds 1, 2)" if i == 0 else None,
                zorder=3)
    if scan is not None:
        tr = np.array(scan["omega_trace_chain0"], float)
        ax.plot(np.arange(len(tr)), tr, color=C_SCAN, linewidth=1.8,
                label=f"scan engine ({scan['dtype']}), chain 0", zorder=4)
        trm = np.array(scan["omega_trace_median"], float)
        ax.plot(np.arange(len(trm)), trm, color=C_SCAN, linewidth=1.2,
                linestyle=":", label="scan engine, chain median", zorder=4)
    ax.axhspan(-3 * 3, 3 * 3, color="#e8f0fb", zorder=1,
               label="omega ~ N(0, 9) bulk")
    _style(ax, "funnel transient from omega = -30 (maxC = 30)"
               + ("" if scan is not None else f"\n{SCAN_WAITS}"))
    ax.set_ylabel("omega", color=INK2, fontsize=9)
    ax.legend(frameon=False, fontsize=8, labelcolor=INK, loc="lower right")

    if scan is not None:
        mh = np.array(scan["micro_h_min_chain0"], float)
        ax2.semilogy(np.arange(len(mh)), mh, color=C_SCAN, linewidth=1.6,
                     zorder=3)
        who = "scan engine chain 0"
    else:
        for i, ch in enumerate(native):
            mh = np.array(ch["micro_h_min"], float)[:400]
            ax2.semilogy(np.arange(len(mh)), mh, color=C_NATIVE,
                         linewidth=1.4, alpha=0.8 if i else 1.0, zorder=3)
        who = "native chains"
    _style(ax2, f"micro step-size floor reached by the halving search ({who})")
    ax2.set_xlabel("iteration", color=INK2, fontsize=9)
    ax2.set_ylabel("min micro h", color=INK2, fontsize=9)
    _save(plt, fig, dst, "fig_funnel_transient.png")
    return scan is not None


def fig_stock_watson_bands(src=HERE, dst=FIGS):
    plt = _plt()
    runs = _load(src, "out_stock_watson.json")["runs"]
    quantities = ("sigma", "z", "x", "tau")
    tags = ("walnuts_d", "walnuts_r2p", "nuts")
    fig, axes = plt.subplots(1, len(quantities),
                             figsize=(2.6 * len(quantities), 3.4), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    for ax, qty in zip(axes, quantities):
        for i, tag in enumerate(tags):
            b = runs[tag]["bands"][qty]
            ax.vlines(i, b["q10"], b["q90"], color=SAMPLER_COLOR[tag],
                      linewidth=5, alpha=0.45, zorder=2)
            ax.plot([i], [b["q50"]], "o", color=SAMPLER_COLOR[tag],
                    markersize=8, zorder=3)
        ax.set_xticks(range(len(tags)))
        ax.set_xticklabels([SAMPLER_LABEL[t].replace("WALNUTS ", "W")
                            for t in tags], fontsize=7, color=INK2)
        ax.set_xlim(-0.6, len(tags) - 0.4)
        _style(ax, qty)
    axes[0].set_ylabel("time-averaged posterior q10 / q50 / q90",
                       color=INK2, fontsize=9)
    fig.suptitle(
        "Stock-Watson on the card: posterior quantile-band agreement "
        "across samplers (out_stock_watson.json; bands are time-averaged)",
        fontsize=10, color=INK)
    _save(plt, fig, dst, "fig_stock_watson_bands.png")


def main(src=HERE, dst=FIGS):
    Path(dst).mkdir(parents=True, exist_ok=True)
    fig_gauss_ess(src, dst)
    fig_gauss_transient(src, dst)
    fig_funnel_transient(src, dst)
    fig_stock_watson_bands(src, dst)
    print("wrote 4 figures to", dst)


if __name__ == "__main__":
    main()
