"""Planck-spectrum generation (counterpart of reference
examples/planck_distribution.ipynb): sample a solar-temperature photon
population and compare the histogram against the analytic density."""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np

import physicl_tpu.light as light

T = 5778.0  # K
kT = float(light.kB.value()) * T
E_min, E_max = 0.1 * kT, 12 * kT

# Reference pattern: one energy per call, memoized CDF
one = light.planck_phot_distribution(E_min, E_max, T)
print("single sample:", repr(one))

# device batch: all N at once by inverse CDF
N = 1_000_000
E = light.planck_sample_E(N, E_min, E_max, T, bins=2000, seed=0)

hist, edges = np.histogram(E, bins=50, range=(E_min, E_max), density=True)
centers = 0.5 * (edges[1:] + edges[:-1])
analytic = np.array([float(light.planck_distribution(x, T).value())
                     for x in centers])
analytic /= np.trapezoid(analytic, centers)

peak_at = centers[np.argmax(hist)]
print(f"sampled peak at E = {peak_at:.3e} J (expect 3 kB T = {3 * kT:.3e} J)")
mask = analytic > 0.05 * analytic.max()
rel = np.abs(hist[mask] - analytic[mask]) / analytic[mask]
print(f"max relative deviation from analytic density: {rel.max():.3f}")

# Build actual photons from the sampled energies (bulk SoA population)
state = light.generate_photon_state(N, E=E)
print(f"photon population ready: {state['n']} photons, "
      f"E mean {state['E'].mean():.3e} J")
