"""Build + execute examples/compton_scattering.ipynb (Klein-Nishina).

Run: python examples/make_compton_nb.py  (executes on the current JAX
backend; the demo uses 10^5-photon runs).
"""

import os
import sys

import nbformat as nbf
from nbconvert.preprocessors import ExecutePreprocessor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CELL0 = '''\
# Compton scattering with exact Klein-Nishina sampling — extension.
#
# The reference package has NO energy-changing interaction: its photons
# keep E forever (physicl/light.py:262-359). Gamma-ray transport needs the
# Compton recoil: a photon of energy E scattering off a free electron at
# rest leaves with E' = E / (1 + alpha (1 - cos t)), alpha = E / m_e c^2,
# and the angular law is the Klein-Nishina differential cross-section.
# ScatterComptonStep samples it exactly (Kahn's rejection method below
# alpha = 1+sqrt(3), Koblinger's direct method above, per photon).
import sys, os
sys.path.insert(0, os.path.dirname(os.getcwd()))
import numpy as np
import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

def one_compton(alpha, n=200_000, seed=7, **kw):
    """One guaranteed scatter from a +x beam of unit-energy photons
    (mec2 = 1/alpha makes alpha the per-photon KN parameter)."""
    s = phys.Simulation(until_t=0.001, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(A=kw.pop("A", 1.0), n=1.0,
                                           mec2=1.0 / alpha, **kw))
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    v = np.asarray(s.sim_state.v)[:, :n]
    E = np.asarray(s.sim_state.E)[:n]
    return v[0] / float(light.c), E

# 511 keV photons (alpha = 1, the classic annihilation line)
cos1, E1 = one_compton(1.0)
scat = E1 != np.float32(1.0)
print(f"scattered fraction: {scat.mean():.4f}")
print(f"<cos t> = {cos1[scat].mean():+.4f}  (KN at alpha=1 is forward-peaked)")
print(f"mean E'/E = {E1[scat].mean():.4f}")
print(f"Compton edge: min E'/E = {E1.min():.4f}  (analytic 1/(1+2a) = {1/3:.4f})")
'''

CELL1 = '''\
# Sampled cos(theta) vs the analytic Klein-Nishina phase function across
# three decades of alpha: Thomson-like dipole at low energy, increasingly
# forward-peaked as alpha grows.
import matplotlib.pyplot as plt

def kn_pdf(ct, a):
    k = 1.0 + a * (1.0 - ct)
    p = (1.0 / k**2) * (k + 1.0 / k - 1.0 + ct**2)
    grid = np.linspace(-1, 1, 4001)
    kk = 1.0 + a * (1.0 - grid)
    norm = np.trapezoid((1.0 / kk**2) * (kk + 1.0 / kk - 1.0 + grid**2), grid)
    return p / norm

ct_grid = np.linspace(-1, 1, 400)
fig, axes = plt.subplots(1, 3, figsize=(11, 3.2), sharey=False)
for ax, a in zip(axes, (0.05, 1.0, 10.0)):
    cos, E = one_compton(a, seed=int(a * 100) + 1)
    sc = E != np.float32(1.0)
    ax.hist(cos[sc], bins=60, range=(-1, 1), density=True, alpha=0.6,
            label="sampled")
    ax.plot(ct_grid, kn_pdf(ct_grid, a), "k-", lw=1.5, label="Klein-Nishina")
    ax.set_title(rf"$\\alpha = {a}$"); ax.set_xlabel(r"$\\cos\\theta$")
    ax.legend()
axes[0].set_ylabel("density")
plt.tight_layout(); plt.savefig("compton_phase.png", dpi=110)
plt.show()
'''

CELL2 = '''\
# The scattered-photon SPECTRUM at alpha = 1: the Compton continuum with
# its sharp edge at E'/E = 1/(1+2 alpha) = 1/3 (180-degree backscatter) —
# the feature every gamma spectroscopist reads off a detector trace.
plt.figure(figsize=(5.5, 3.4))
plt.hist(E1[scat], bins=80, range=(0.3, 1.0), density=True, alpha=0.7)
plt.axvline(1/3, color="k", ls="--", lw=1.2,
            label=r"Compton edge $\\frac{1}{1+2\\alpha}$")
plt.xlabel(r"$E'/E$"); plt.ylabel("density")
plt.title(r"Single-scatter energy spectrum, $\\alpha = 1$ (511 keV)")
plt.legend(); plt.tight_layout(); plt.savefig("compton_spectrum.png", dpi=110)
plt.show()
edge_frac = (np.abs(E1[scat] - 1/3) < 0.01).mean()
print(f"fraction within 0.01 of the edge: {edge_frac:.4f} "
      "(the backscatter pile-up)")
'''

CELL3 = '''\
# Compton cooling: over many scatters every photon random-walks DOWN in
# energy — E is monotone non-increasing off stationary electrons. Track the
# mean energy of a 10 MeV-class population (alpha0 = 20) through ~60
# scattering steps, with the physical Klein-Nishina total cross-section
# (kn_cross_section=True): as photons cool, sigma_KN RISES toward the
# Thomson limit, so cooling accelerates — the textbook nonlinearity.
steps, dt = 120, 0.001
A_half = 0.5 / (float(light.c) * dt)   # ~0.5 Thomson collisions / step
s = phys.Simulation(until_t=steps * dt, seed=11)
s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(dt)))
s.add_step(1, phys.newton.NewtonianKinematicsStep())
s.add_step(2, light.ScatterComptonStep(A=A_half, n=1.0, mec2=1.0 / 20.0,
                                       kn_cross_section=True))
s.add_step(3, phys.ReduceMeasureStep(None, lambda p: {"E_sum": p.E},
                                     outputs=("E_sum",), measure_n=True))
s.add_photons(light.generate_photon_state(100_000, E=1.0))
s.start(); s.join()
assert s.used_fused
rows = np.asarray(s.steps[3].data, dtype=np.float64)  # [t, n, E_sum]
ts, hist = rows[:, 0], rows[:, 2] / rows[:, 1]

plt.figure(figsize=(5.5, 3.4))
plt.semilogy(ts / dt, hist * 20.0, lw=1.5)
plt.xlabel("scattering step"); plt.ylabel(r"$\\langle \\alpha \\rangle$")
plt.title("Compton cooling of a 10 MeV-class photon population")
plt.tight_layout(); plt.savefig("compton_cooling.png", dpi=110)
plt.show()
print(f"<alpha> start {hist[0]*20:.2f} -> end {hist[-1]*20:.3f} "
      f"({steps} steps)")
# per-photon E is exactly non-increasing (eta >= 1); the POPULATION mean
# is assembled from f32 in-kernel sums, so allow f32 accumulation noise
assert (np.diff(hist) <= 1e-6 * hist[:-1]).all(), \\
    "energy must be non-increasing"
'''


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_code_cell(c) for c in (CELL0, CELL1, CELL2,
                                                  CELL3)]
    ep = ExecutePreprocessor(timeout=2400)
    ep.preprocess(nb, {"metadata": {"path": HERE}})
    out = os.path.join(HERE, "compton_scattering.ipynb")
    from _nbbuild import write_executed
    write_executed(nb, out)


if __name__ == "__main__":
    sys.exit(main())
