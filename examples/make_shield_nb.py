"""Build + execute examples/deep_shield.ipynb (weighted-transport demo).

Transmission through an absorbing shield measured two ways in one figure:
analog transport (the reference's only mode — survivors counted) vs
implicit capture + Russian roulette (statistical weights). The analog
estimate dies into shot noise at optical depth tau ~ ln(N); the weighted
estimate tracks the analytic e^-tau for as deep as you care to run.

Run: python examples/make_shield_nb.py  (executes on the current backend;
set PHYSICL_NB_SMALL=1 for a fast small-population smoke run).
"""

import os
import sys

import nbformat as nbf
from nbconvert.preprocessors import ExecutePreprocessor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
SMALL = os.environ.get("PHYSICL_NB_SMALL") == "1"

N_ANALOG = 200_000 if SMALL else 4_000_000
N_WEIGHTED = 20_000 if SMALL else 400_000

CELL0 = f'''\
# Deep-shield transmission: analog vs weighted Monte Carlo.
#
# A photon beam enters a uniform absorber (optical depth tau = n sigma c t
# grows linearly with time). Analytic transmission: T(tau) = e^-tau.
#
# Analog transport (the reference's only mode) kills photons outright:
# at depth tau the expected survivor count is N e^-tau, so the estimate
# carries relative shot noise ~ 1/sqrt(N e^-tau) — past tau ~ ln(N) there
# are NO survivors and the measured curve is zero (minus infinity on a log
# plot). Implicit capture replaces the kill with a deterministic weight
# decay w *= (1 - p) per step: the per-photon weight IS e^-tau exactly, so
# the transmission estimate is draw-free at any depth. Russian roulette
# culls the dead-weight population unbiasedly to keep the alive count (and
# the compute) bounded. Both run inside the same fused kernel; the
# weighted run uses 10x FEWER photons.
import sys, os
sys.path.insert(0, os.path.dirname(os.getcwd()))
if os.environ.get("PHYSICL_NB_SMALL") == "1":   # CPU smoke mode
    import jax
    jax.config.update("jax_platforms", "cpu")
import time
import numpy as np
import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

p_step = 0.2          # tau per iteration
iters = 120           # tau_max = 24  (analog can resolve only ~ln(N) ~ 15)
dt = 0.001
c = float(light.c)
A = p_step / (c * dt)

def run(n_phot, **del_kw):
    s = phys.Simulation(until_t=iters * dt, seed=17)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(dt)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    dele = light.ScatterDeleteStep(np.double(1.0), np.double(A),
                                   measure_deposition=True, **del_kw)
    s.add_step(2, dele)
    red = phys.ReduceMeasureStep(None, lambda p: {{"W": p.w}},
                                 outputs=("W",), measure_n=True)
    s.add_step(3, red)
    s.add_photons(light.generate_photon_state(n_phot, E=1.0))
    t0 = time.perf_counter()
    s.start(); s.join()
    wall = time.perf_counter() - t0
    rows = np.array(red.data, dtype=float)
    dep = np.array(dele.data, dtype=float)
    return rows, wall, s, dep

n_analog, n_weighted = {N_ANALOG}, {N_WEIGHTED}
rows_a, wall_a, sim_a, dep_a = run(n_analog)                # analog
rows_w, wall_w, sim_w, dep_w = run(n_weighted, implicit_capture=True,
                                   roulette=(1e-9, 2e-9))   # weighted
assert sim_a.used_fused and sim_w.used_fused
k = min(rows_a.shape[0], rows_w.shape[0])
# exact DISCRETE optical depth: each iteration is a Bernoulli(p_step)
# absorption trial, so analytic transmission after k steps is
# (1-p)^k = e^-tau with tau = -k ln(1-p). (tau = p*k only as p -> 0.)
tau = -np.log(1.0 - p_step) * np.arange(1, k + 1)
T_analog = rows_a[:k, 1] / n_analog        # survivor count (w=1 each)
T_weighted = rows_w[:k, 2] / n_weighted    # Sigma w
print(f"analog:   N={{n_analog:.0e}}  wall {{wall_a:.1f}} s  "
      f"survivors at tau={{tau[-1]:.1f}}: {{int(rows_a[k - 1, 1])}}")
print(f"weighted: N={{n_weighted:.0e}}  wall {{wall_w:.1f}} s  "
      f"alive at tau={{tau[-1]:.1f}}: {{int(rows_w[k - 1, 1])}}  "
      f"T={{T_weighted[-1]:.3e}} (e^-tau = {{np.exp(-tau[-1]):.3e}})")
'''

CELL1 = '''\
# The money plot: both estimators against e^-tau on a log scale, plus the
# dose curve from the deposition tally (cumulative absorbed energy
# fraction = 1 - e^-tau; energy conservation is exact on both paths).
import matplotlib.pyplot as plt

fig, (ax, ax2, ax3) = plt.subplots(1, 3, figsize=(14.5, 4))

ax.semilogy(tau, np.exp(-tau), "k-", lw=1.2, label=r"analytic $e^{-\\tau}$")
ok = T_analog > 0
ax.semilogy(tau[ok], T_analog[ok], "o", ms=3.5, mfc="none",
            label=f"analog, N={n_analog:.0e}")
ax.semilogy(tau, T_weighted, "s", ms=3, mfc="none",
            label=f"implicit capture + roulette, N={n_weighted:.0e}")
ax.axvline(np.log(n_analog), color="0.6", lw=0.8, ls=":",
           label=r"analog wall $\\tau = \\ln N$")
ax.set_xlabel(r"optical depth $\\tau$"); ax.set_ylabel("transmission")
ax.set_title("deep-shield transmission"); ax.legend(fontsize=8)

# relative error of each estimator vs the analytic curve
ax2.semilogy(tau[ok], np.abs(T_analog[ok] / np.exp(-tau[ok]) - 1), "o",
             ms=3.5, mfc="none", label="analog")
ax2.semilogy(tau, np.abs(T_weighted / np.exp(-tau) - 1), "s", ms=3,
             mfc="none", label="weighted")
ax2.set_xlabel(r"optical depth $\\tau$")
ax2.set_ylabel("relative error vs analytic")
ax2.set_title("estimator error"); ax2.legend(fontsize=8)

# dose curve: cumulative deposited-energy fraction vs depth
dose_a = np.cumsum(dep_a[:k, 1]) / n_analog
dose_w = np.cumsum(dep_w[:k, 1]) / n_weighted
ax3.plot(tau, 1 - np.exp(-tau), "k-", lw=1.2,
         label=r"analytic $1 - e^{-\\tau}$")
ax3.plot(tau[::4], dose_a[::4], "o", ms=3.5, mfc="none", label="analog")
ax3.plot(tau[::4], dose_w[::4], "s", ms=3, mfc="none", label="weighted")
ax3.set_xlabel(r"optical depth $\\tau$")
ax3.set_ylabel("cumulative absorbed fraction")
ax3.set_title("dose curve (measure_deposition)")
ax3.legend(fontsize=8)
plt.tight_layout(); plt.savefig("deep_shield.png", dpi=110)
plt.show()

# energy conservation audits (E0 = 1 per photon):
# weighted: deposited + in-flight weight is the initial energy, exactly,
# until roulette (unbiased bookkeeping) starts trading weight for photons
pre = tau <= 20
budget_w = dose_w + rows_w[:k, 2] / n_weighted
assert np.abs(budget_w[pre] - 1).max() < 1e-3
# analog: deposited + surviving count is exact per realization, all depths
budget_a = dose_a + rows_a[:k, 1] / n_analog
assert np.abs(budget_a - 1).max() < 1e-6
print(f"dose at tau=3: {dose_w[np.searchsorted(tau, 3.0)]:.4f} "
      f"(analytic {1 - np.exp(-tau[np.searchsorted(tau, 3.0)]):.4f})")

# quantitative: the weighted estimate is deterministic-exact until roulette
# engages (w falls below w_min = 1e-9 near tau ~ 20.7), then statistical;
# the analog estimate loses every photon around tau ~ ln N.
pre_roulette = tau <= 20
err_w = np.abs(T_weighted[pre_roulette] / np.exp(-tau[pre_roulette]) - 1)
print(f"weighted max relative error, tau <= 20 (draw-free regime): "
      f"{err_w.max() * 100:.3f}%")
assert err_w.max() < 0.005
deep = tau >= np.log(n_analog) + 4     # expected survivors < e^-4 = 0.02
assert rows_a[:k, 1][deep].sum() <= 2, "analog should be extinct this deep"
assert np.abs(T_weighted[-1] / np.exp(-tau[-1]) - 1) < 0.5  # roulette noise
'''


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_code_cell(c) for c in (CELL0, CELL1)]
    ep = ExecutePreprocessor(timeout=3600)
    ep.preprocess(nb, {"metadata": {"path": HERE}})
    out = os.path.join(HERE, "deep_shield.ipynb")
    from _nbbuild import write_executed
    write_executed(nb, out)


if __name__ == "__main__":
    sys.exit(main())
