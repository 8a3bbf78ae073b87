"""Build + execute examples/voxel_phantom.ipynb (3-D voxel media on the
fused kernel: CT-phantom beam attenuation vs the exact line-integral law).

Run: python examples/make_voxel_nb.py  (executes on the current JAX
backend; PHYSICL_NB_SMALL=1 pins the CPU backend for a smoke run — the
ray count is one per grid column either way, already smoke-sized).
"""

import os
import sys

import nbformat as nbf
from nbconvert.preprocessors import ExecutePreprocessor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CELL0 = '''\
# 3-D voxel media INSIDE the fused kernel (extension; the reference
# splices analytic n(r) C-expressions into its OpenCL kernel,
# physicl/light.py:295-315, but has no gridded media at all).
#
# light.voxel_density(grid) rides to VMEM as a compact (V/128, 128)
# table; every photon's lookup is a segmented LANE gather inside the
# Pallas kernel — the transport never leaves the fused path (grids up
# to light.MAX_FUSED_VOXELS entries; check sim.explain_plan()).
#
# Phantom: two Gaussian blobs + a dense rod in a 16x16x16 grid. A
# pencil beam crosses it under implicit capture, so each photon's
# weight is the DETERMINISTIC product prod_k (1 - A n(x_k) c dt):
# transmission equals the discretized Beer-Lambert line integral
# exactly — a per-ray closed form the transport must hit to f32
# roundoff, not a statistical test.
import sys, os
sys.path.insert(0, os.path.dirname(os.getcwd()))
if os.environ.get("PHYSICL_NB_SMALL") == "1":   # CPU smoke mode
    import jax
    jax.config.update("jax_platforms", "cpu")
import numpy as np
import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

NX = NY = NZ = 16
c_dt = float(light.c) * 1e-3
SPACING = c_dt                      # one voxel per flight step
ii, jj, kk = np.meshgrid(*(np.arange(n) for n in (NX, NY, NZ)),
                         indexing="ij")


def blob(cx, cy, cz, s, amp):
    return amp * np.exp(-(((ii - cx) ** 2 + (jj - cy) ** 2
                           + (kk - cz) ** 2) / (2 * s * s)))


grid = (blob(5, 8, 8, 2.5, 1.6) + blob(11, 7, 9, 1.8, 2.4)).astype(np.float32)
grid[7:9, 3:13, 7:9] += 3.0         # dense rod
nfn = light.voxel_density(grid, origin=(0.0, 0.0, 0.0), spacing=SPACING)

N_RAYS = NY * NZ                    # one ray per (y, z) voxel column
A = 0.04 / c_dt                     # per-voxel optical depth 0.04 * n
ys, zs = np.meshgrid(np.arange(NY), np.arange(NZ), indexing="ij")
r0 = np.stack([np.full(N_RAYS, -0.75 * SPACING),
               ys.ravel() * SPACING, zs.ravel() * SPACING])

s = phys.Simulation(until_t=17e-3 * 0.9999, seed=0)
s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
s.add_step(1, phys.newton.NewtonianKinematicsStep())
s.add_step(2, light.ScatterDeleteStep(
    np.double(1.0), np.double(A), variable_n=True, variable_n_fn=nfn,
    implicit_capture=True))
s.add_photons(light.generate_photon_state(N_RAYS, E=1.0, r=r0))
s.start(); s.join()
assert s.used_fused, s.explain_plan()

w = np.asarray(s.sim_state.w, np.float64)[:N_RAYS].reshape(NY, NZ)

# exact prediction: photons start at x = -0.75 dx and step one voxel per
# iteration, so iteration k samples x = (k - 0.75) dx -> nearest voxel
# ix = k - 1: iteration 1 reads grid[0], iteration NX reads grid[NX-1],
# and only iteration NX+1 samples outside the coverage (vacuum)
pred = np.ones((NY, NZ))
for k in range(1, NX + 1):
    pred *= 1.0 - 0.04 * grid[k - 1].astype(np.float64)
err = np.abs(w - pred).max()
print(f"max |transmission - exact line integral| = {err:.2e}")
assert err < 1e-5
'''

CELL1 = '''\
# Radiograph: the transported transmission image vs the phantom.
import matplotlib.pyplot as plt

fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(9.6, 4))
im0 = ax0.imshow(grid.sum(axis=0).T, origin="lower", cmap="magma")
ax0.set_title("phantom: integrated density along x")
ax0.set_xlabel("y voxel"); ax0.set_ylabel("z voxel")
plt.colorbar(im0, ax=ax0, shrink=0.85)
im1 = ax1.imshow(-np.log(np.maximum(w, 1e-12)).T, origin="lower",
                 cmap="viridis")
ax1.set_title("transport radiograph: optical depth -ln T")
ax1.set_xlabel("y voxel"); ax1.set_ylabel("z voxel")
plt.colorbar(im1, ax=ax1, shrink=0.85)
plt.tight_layout(); plt.savefig("voxel_phantom.png", dpi=110)
plt.show()
print("plan:", s.plan_report.mode, "| max error vs closed form:",
      f"{err:.2e}")
'''


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_code_cell(c) for c in (CELL0, CELL1)]
    ep = ExecutePreprocessor(timeout=2400)
    ep.preprocess(nb, {"metadata": {"path": HERE}})
    out = os.path.join(HERE, "voxel_phantom.ipynb")
    from _nbbuild import write_executed
    write_executed(nb, out)


if __name__ == "__main__":
    sys.exit(main())
