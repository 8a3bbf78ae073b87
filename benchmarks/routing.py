"""Where the planner sends plans the Triton kernel does not take.

    python3 benchmarks/routing.py [--photons N] [--bins 8,16,32,56]

Times, through the engine's own providers (``run_all.steady_rate`` and
``run_all.generic_steady_rate``), the Triton kernel, the XLA chunk and the
generic scan on:

- spectrum plans whose record-column count crosses
  ``ops/fused.KERNEL_MAX_REC_COLS``: one ``SpectrumMeasureStep`` of B bins
  (plus underflow and overflow) behind a light body (isotropic scatter)
  and a heavy one (thermal Compton);
- the element-wise ``KernelStep`` plan, which the kernel cannot lower.

Prints one line per rate and writes ``chiprun_out/routing_<photons>.json``.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import run_all  # noqa: E402


def _base(n, body):
    import physicl_tpu as phys
    import physicl_tpu.light as light
    import physicl_tpu.newton as newton

    s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, newton.NewtonianKinematicsStep())
    if body == "iso":
        s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                                 n=np.double(0.001)))
    else:  # thermal Compton, as run_all's spectrum row
        s.add_step(2, light.ScatterComptonStep(
            A=0.001 / (float(light.c) * 1e-3), n=1.0, mec2=1e9,
            theta_e=0.01))
    s.add_photons(light.generate_photon_state(n, E=1.0))
    return s


def spectrum(n, body, bins):
    import physicl_tpu.light as light

    def build():
        s = _base(n, body)
        s.add_step(3, light.SpectrumMeasureStep(
            None, edges=np.exp(np.linspace(-3.0, 4.0, bins + 1)),
            measure_n=True, underflow=True, overflow=True))
        return s

    return build


def drag(n):
    from physicl_tpu.kernels import KernelStep

    def build():
        s = _base(n, "iso")
        s.add_step(3, KernelStep(
            lambda st, ctx: st.replace(v=st.v * (1.0 - 1e-7)),
            elementwise=True))
        return s

    return build


def columns(build):
    from physicl_tpu.ops import fused as F
    from physicl_tpu.ops.pipeline import try_build_fused
    from physicl_tpu.state import SimState

    sim = build()
    state = SimState.from_population(sim._pending_objects, sim._pending_bulk)
    steps = sim._ordered_steps()
    for s in steps:
        s.setup(sim)
    plan = try_build_fused(sim, steps, state).plan
    return F._record_columns(plan), F.kernel_lowers(plan)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--photons", type=int, default=1_000_000)
    ap.add_argument("--bins", default="8,16,32,56")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    n = args.photons
    cases = [(f"spectrum_{body}_{b}bin", spectrum(n, body, b))
             for body in ("iso", "compton")
             for b in map(int, filter(None, args.bins.split(",")))]
    cases.append(("kernelstep_drag", drag(n)))
    rows = []
    for name, build in cases:
        cols, refused = columns(build)
        row = dict(case=name, record_columns=cols, photons=n)
        for builder in ("triton", "xla", "generic"):
            if builder == "triton" and refused is not None:
                continue
            if builder == "generic":
                rate = run_all.generic_steady_rate(build, n)
            else:
                rate = run_all.steady_rate(build, n, builder=builder)
            row[builder] = rate
            print(f"{name} ({cols} columns) {builder} {rate:.4e} "
                  "photon-steps/s", flush=True)
        rows.append(row)
    os.makedirs(os.path.join(os.path.dirname(HERE), "chiprun_out"),
                exist_ok=True)
    with open(os.path.join(os.path.dirname(HERE), "chiprun_out",
                           f"routing_{n}.json"), "w") as fh:
        json.dump({"card": card, "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
