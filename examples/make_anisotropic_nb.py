"""Build + execute examples/anisotropic_scattering.ipynb (HG phase function).

Run: python examples/make_anisotropic_nb.py  (executes on the current JAX
backend; CPU is fine — the demo uses 50k photons for one iteration each).
"""

import os
import sys

import nbformat as nbf
from nbconvert.preprocessors import ExecutePreprocessor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CELL0 = '''\
# Anisotropic (Henyey-Greenstein) scattering — extension.
#
# The reference package scatters isotropically only (physicl/light.py:262).
# ScatterHenyeyGreensteinStep adds the standard single-parameter anisotropic
# phase function: p(cos t) = (1 - g^2) / (2 (1 + g^2 - 2 g cos t)^{3/2}),
# with <cos t> = g. Forward-peaked (g > 0) transport is the Mie/aerosol
# regime; g = 0 reduces to exact area-uniform isotropic scattering.
import sys, os
sys.path.insert(0, os.path.dirname(os.getcwd()))
import numpy as np
import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

def one_scatter_cosines(g, n=50_000, seed=7):
    """One guaranteed scatter from a +x beam; return cos(theta) samples."""
    s = phys.Simulation(until_t=0.001, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterHenyeyGreensteinStep(A=1.0, n=1.0, g=g))
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    v = np.asarray(s.sim_state.v)[:, :n]
    return v[0] / float(light.c)

def hg_pdf(ct, g):
    if abs(g) < 1e-12:
        return np.full_like(ct, 0.5)
    return 0.5 * (1 - g**2) / (1 + g**2 - 2*g*ct) ** 1.5

gs = [0.0, 0.4, 0.8, -0.5]
cos_samples = {g: one_scatter_cosines(g) for g in gs}
for g in gs:
    print(f"g={g:+.1f}: <cos t> = {cos_samples[g].mean():+.4f}")
'''

CELL1 = '''\
# Sampled cos(theta) histograms vs the analytic HG density.
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, len(gs), figsize=(4 * len(gs), 3), sharey=False)
ct = np.linspace(-0.999, 0.999, 400)
for ax, g in zip(axes, gs):
    ax.hist(cos_samples[g], bins=60, range=(-1, 1), density=True,
            alpha=0.6, label="sampled")
    ax.plot(ct, hg_pdf(ct, g), "k-", lw=1.5, label="HG analytic")
    ax.set_title(f"g = {g:+.1f}")
    ax.set_xlabel("cos t")
axes[0].set_ylabel("density")
axes[0].legend()
plt.tight_layout()
plt.savefig("anisotropic_scattering.png", dpi=110)
print("max |hist - pdf| checks:")
for g in gs:
    hist, edges = np.histogram(cos_samples[g], bins=40, range=(-1, 1),
                               density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    ref = hg_pdf(centers, g)
    mask = ref < 5  # skip the forward singularity bins (finite-bin bias)
    err = np.abs(hist - ref)[mask].max()
    print(f"  g={g:+.1f}: {err:.3f}")
'''

CELL2 = '''\
# Multiple scattering: a forward-peaked medium randomizes direction far
# slower than an isotropic one. Track the +x share over iterations.
def relaxation(step, n=20_000, iters=30, seed=1):
    s = phys.Simulation(until_t=0.001 * iters, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, step)
    sign = light.ScatterSignMeasureStep(None, True)
    s.add_step(3, sign)
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    return [r[2] / r[1] for r in sign.data]

A = n_ = 0.0005  # pcoll ~ 0.075 per step
iso = relaxation(light.ScatterIsotropicStep(A=A, n=n_))
fwd = relaxation(light.ScatterHenyeyGreensteinStep(A=A, n=n_, g=0.9))
plt.figure(figsize=(6, 3.2))
plt.plot(iso, label="isotropic")
plt.plot(fwd, label="HG g=0.9 (forward-peaked)")
plt.xlabel("iteration"); plt.ylabel("+x share"); plt.legend()
plt.tight_layout(); plt.savefig("anisotropic_relaxation.png", dpi=110)
print(f"+x share after {len(iso)} steps: iso={iso[-1]:.3f}  hg(g=0.9)={fwd[-1]:.3f}")
'''

CELL3 = """\
# USER-DEFINED phase functions (ScatterPhaseFunctionStep): any angular law,
# as an exact inverse-CDF callable or a tabulated (mu, pdf) phase table —
# the table becomes a gather-free piecewise-linear inverse CDF traced into
# the fused kernel (Mie lookup tables, measured tissue/aerosol phase
# functions, ...). Validate two: a forward-peaked exp(3 mu) table against
# its analytic density, and a tabulated Rayleigh dipole against the
# closed-form ScatterRayleighStep.
def one_scatter_custom(step, n=50_000, seed=9):
    s = phys.Simulation(until_t=0.001, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, step)
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    v = np.asarray(s.sim_state.v)[:, :n]
    return v[0] / float(light.c)

mu = np.linspace(-1, 1, 501)
exp_tab = one_scatter_custom(light.ScatterPhaseFunctionStep(
    A=1.0, n=1.0, phase_table=(mu, np.exp(3.0 * mu)), table_bins=128))
ray_tab = one_scatter_custom(light.ScatterPhaseFunctionStep(
    A=1.0, n=1.0, phase_table=(mu, 1.0 + mu ** 2), table_bins=128))
ray_exact = one_scatter_custom(light.ScatterRayleighStep(A=1.0, n=1.0))

fig, (ax, ax2) = plt.subplots(1, 2, figsize=(9, 3.2))
ct = np.linspace(-1, 1, 400)
ax.hist(exp_tab, bins=60, range=(-1, 1), density=True, alpha=0.6,
        label="sampled (128-bin table)")
ax.plot(ct, np.exp(3 * ct) * 3 / (np.exp(3.0) - np.exp(-3.0)), "k-",
        lw=1.5, label="analytic $e^{3\\mu}$ density")
ax.set_title(f"tabulated $e^{{3\\mu}}$: <cos t> = {exp_tab.mean():.4f} "
             f"(coth 3 - 1/3 = {1 / np.tanh(3.0) - 1 / 3.0:.4f})")
ax.set_xlabel("cos t"); ax.legend(fontsize=8)
ax2.hist(ray_tab, bins=60, range=(-1, 1), density=True, alpha=0.5,
         label="tabulated (1 + mu^2)")
ax2.hist(ray_exact, bins=60, range=(-1, 1), density=True, alpha=0.5,
         histtype="step", lw=1.6, label="ScatterRayleighStep (exact)")
ax2.plot(ct, (3 / 8) * (1 + ct ** 2), "k-", lw=1.2, label="dipole analytic")
ax2.set_title(f"Rayleigh: table <mu^2> = {np.mean(ray_tab ** 2):.4f}, "
              f"exact {np.mean(ray_exact ** 2):.4f} (2/5 analytic)")
ax2.set_xlabel("cos t"); ax2.legend(fontsize=8)
plt.tight_layout(); plt.savefig("phase_functions.png", dpi=110)
assert abs(exp_tab.mean() - (1 / np.tanh(3.0) - 1 / 3.0)) < 0.01
assert abs(np.mean(ray_tab ** 2) - 0.4) < 0.01
assert abs(np.mean(ray_exact ** 2) - 0.4) < 0.01
print("phase-table moments validated against analytic laws")
"""


CELL4 = """\
# Real Mie scattering: build the phase table straight from the
# Bohren-Huffman series (mie_phase_table) and transport with it.
fig, (ax, ax2) = plt.subplots(1, 2, figsize=(9, 3.2))
for x_sz, m_idx, style in ((3.0, 1.33, "-"), (10.0, 1.5 + 0.01j, "--")):
    mu_g, pdf, g = light.mie_phase_table(x_sz, m_idx, n_mu=2001)
    pdf_n = pdf / np.trapezoid(pdf, mu_g)
    ax.semilogy(mu_g, pdf_n, style,
                label=f"x={x_sz}, m={m_idx} (g={g:.3f})")
    cs = one_scatter_custom(light.ScatterPhaseFunctionStep(
        A=1.0, n=1.0, phase_table=(mu_g, pdf), table_bins=256))
    hist, edges = np.histogram(cs, bins=50, range=(-1, 1), density=True)
    ax2.semilogy(0.5 * (edges[1:] + edges[:-1]), hist, style,
                 label=f"sampled x={x_sz}: <mu>={cs.mean():.3f} (g={g:.3f})")
    assert abs(cs.mean() - g) < 0.02
ax.set_xlabel("cos t"); ax.set_ylabel("p (normalized)")
ax.set_title("Bohren-Huffman Mie phase functions"); ax.legend(fontsize=8)
ax2.set_xlabel("cos t"); ax2.set_title("transported samples (fused kernel)")
ax2.legend(fontsize=8)
plt.tight_layout(); plt.savefig("mie_phase.png", dpi=110)
print("Mie transport moments land on the series asymmetry parameter")
"""


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_code_cell(c) for c in (CELL0, CELL1, CELL2, CELL3, CELL4)]
    ep = ExecutePreprocessor(timeout=1200)
    ep.preprocess(nb, {"metadata": {"path": HERE}})
    out = os.path.join(HERE, "anisotropic_scattering.ipynb")
    from _nbbuild import write_executed
    write_executed(nb, out)


if __name__ == "__main__":
    sys.exit(main())
