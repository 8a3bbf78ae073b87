"""Build + execute examples/rayleigh_phase.ipynb (true dipole phase function).

Run: python examples/make_rayleigh_nb.py  (executes on the current JAX
backend; the demo uses 10^5-photon single-iteration runs).
"""

import os
import sys

import nbformat as nbf
from nbconvert.preprocessors import ExecutePreprocessor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CELL0 = '''\
# Rayleigh scattering with the TRUE dipole phase function — extension.
#
# The reference package applies the lambda^-4 Rayleigh CROSS-SECTION but
# redirects isotropically (physicl/light.py:262-359). For sky/atmosphere
# problems the angular distribution matters: molecular (dipole) scattering
# follows p(cos t) = (3/8)(1 + cos^2 t) — forward/backward symmetric with
# a 2:1 peak-to-side ratio, the origin of sky-brightness and polarization
# patterns. ScatterRayleighStep samples it exactly via a closed-form
# Cardano inverse CDF (defining moment: <cos^2 t> = 2/5; isotropic = 1/3).
import sys, os
sys.path.insert(0, os.path.dirname(os.getcwd()))
import numpy as np
import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

def one_scatter_cosines(step, n=100_000, seed=7):
    """One guaranteed scatter from a +x beam; return cos(theta) samples."""
    s = phys.Simulation(until_t=0.001, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, step)
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    v = np.asarray(s.sim_state.v)[:, :n]
    return v[0] / float(light.c)

ray = one_scatter_cosines(light.ScatterRayleighStep(A=1.0, n=1.0))
iso = one_scatter_cosines(light.ScatterIsotropicStep(A=1.0, n=1.0))
print(f"Rayleigh:  <cos t> = {ray.mean():+.4f}   <cos^2 t> = {(ray**2).mean():.4f}  (analytic 2/5)")
print(f"isotropic (reference behaviour): <cos^2 t> = {(iso**2).mean():.4f}")
'''

CELL1 = '''\
# Sampled cos(theta) density vs the analytic dipole phase function, next to
# what the reference would produce (its angle-uniform resample).
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

ct = np.linspace(-1, 1, 400)
fig, axes = plt.subplots(1, 2, figsize=(9, 3.2), sharey=True)
axes[0].hist(ray, bins=60, range=(-1, 1), density=True, alpha=0.6,
             label="sampled")
axes[0].plot(ct, (3/8) * (1 + ct**2), "k-", lw=1.5,
             label=r"$\\frac{3}{8}(1+\\cos^2\\theta)$")
axes[0].set_title("ScatterRayleighStep (dipole phase)")
axes[1].hist(iso, bins=60, range=(-1, 1), density=True, alpha=0.6,
             color="tab:orange", label="sampled")
axes[1].set_title("reference-style redirect")
for ax in axes:
    ax.set_xlabel(r"$\\cos\\theta$"); ax.legend()
axes[0].set_ylabel("density")
plt.tight_layout(); plt.savefig("rayleigh_phase.png", dpi=110)

hist, edges = np.histogram(ray, bins=40, range=(-1, 1), density=True)
centers = 0.5 * (edges[1:] + edges[:-1])
err = np.abs(hist - (3/8) * (1 + centers**2)).max()
print(f"max |hist - analytic| over 40 bins: {err:.4f}")
'''

CELL2 = '''\
# Why the sky is blue AND why it dims toward the sun: combine the
# lambda^-4 cross-section (wavelength_dep_scattering=True) with the dipole
# phase. Blue (450 nm) vs red (700 nm) scattering rates and the angular
# pattern of the singly-scattered light.
# pcoll = A*n*c*dt*lambda^-4; pick A so one step scatters 15% of 450 nm light
A_xsec = 0.15 / (float(light.c) * 0.001 * (450e-9) ** -4)

def scatter_stats(wl_nm, n=200_000, seed=3):
    E = float(light.E_from_wavelength(
        phys.Measurement(wl_nm * 1e-9, "m**1")).value())
    s = phys.Simulation(until_t=0.001, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterRayleighStep(
        A=A_xsec, n=1.0, wavelength_dep_scattering=True))
    s.add_photons(light.generate_photon_state(n, E=E))
    s.start(); s.join()
    dv = np.asarray(s.sim_state.dv)[:, :n]
    v = np.asarray(s.sim_state.v)[:, :n]
    scat = np.any(dv != 0, axis=0)
    return scat.mean(), v[0, scat] / float(light.c)

f450, cos450 = scatter_stats(450.0)
f700, _ = scatter_stats(700.0)
print(f"scatter fraction 450nm: {f450:.4f}   700nm: {f700:.4f}")
print(f"blue/red ratio: {f450/f700:.2f}   (lambda^-4 predicts "
      f"{(700/450)**4:.2f})")

plt.figure(figsize=(5, 3.2))
plt.hist(cos450, bins=40, range=(-1, 1), density=True, alpha=0.6,
         label="single-scattered 450 nm")
plt.plot(ct, (3/8) * (1 + ct**2), "k-", lw=1.5, label="dipole phase")
plt.xlabel(r"$\\cos\\theta$ (to the sun)"); plt.ylabel("density")
plt.legend(); plt.tight_layout(); plt.savefig("rayleigh_sky.png", dpi=110)
print("forward/side brightness ratio "
      f"{(3/8)*2 / ((3/8)*1):.1f} : 1 (dipole), vs 1 : 1 isotropic")
'''


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_code_cell(c) for c in (CELL0, CELL1, CELL2)]
    ep = ExecutePreprocessor(timeout=1200)
    ep.preprocess(nb, {"metadata": {"path": HERE}})
    out = os.path.join(HERE, "rayleigh_phase.ipynb")
    from _nbbuild import write_executed
    write_executed(nb, out)


if __name__ == "__main__":
    sys.exit(main())
