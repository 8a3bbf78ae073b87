#!/usr/bin/env python3
"""Smoke test of physicl_tpu on one NVIDIA GPU, through its normal entry points.

    python3 chip_smoke.py            # phases 1-4 on one card
    python3 chip_smoke.py --multi    # the four-card mesh path only

Phases (any failure exits nonzero; nothing is caught):

1. the bench.py headline — isotropic scatter plus sign tallies on 10^7
   photons — through ``Simulation.start()/join()`` on the fused tier, with
   the sign-share relaxation law checked to 0.02 and the rate printed;
2. the same workload on the generic scan (``fuse="off"``);
3. for every op family (``physicl_tpu/ops/families.py``), the Triton chunk
   kernel against the XLA chunk at 2^20 photons x 256 iterations: identical
   random bits, the tolerances of ``families.compare_chunks``, both rates;
4. the physics validation checks of ``scripts/validate_chip.py``.

``--multi`` runs the fused and generic mesh legs of
``__graft_entry__.mesh_legs`` and the headline on ``make_mesh(4)`` at 10^6
photons per card, and checks that each card holds a quarter of the particle
planes, the exact global census, and per-iteration tallies that match a one-card
run statistically.

The last line of standard output is one JSON object naming the device. The
script exits nonzero without it when JAX finds no GPU or the repository is
not beside it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def headline_sim(n, until_iters, chunk, mesh=None, fuse="auto", seed=0):
    """The bench.py headline: Euler kinematics + isotropic scatter + sign
    tallies, ``until_iters`` iterations of dt = 1 ms."""
    import physicl_tpu as phys
    import physicl_tpu.light as light
    import physicl_tpu.newton as newton

    sim = phys.Simulation(until_t=(until_iters - 0.5) * 0.001, seed=seed,
                          chunk_steps=chunk, mesh=mesh, fuse=fuse)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                               n=np.double(0.001)))
    meas = light.ScatterSignMeasureStep(None, True)
    sim.add_step(3, meas)
    sim.add_photons(light.generate_photon_state(n, E=1.0))
    return sim, meas


def sign_law_error(meas):
    """Largest deviation of the +x share from 0.5 + 0.5 (1 - pcoll)^k."""
    import physicl_tpu.light as light

    data = np.asarray(meas.data, np.float64)
    shares = data[:, 2] / np.maximum(data[:, 1], 1)
    pcoll = 0.001 * 0.001 * float(light.c) * 0.001
    expect = 0.5 + 0.5 * (1 - pcoll) ** np.arange(1, len(shares) + 1)
    return float(np.abs(shares - expect).max()), shares


def run_timed(sim):
    t0 = time.perf_counter()
    sim.start()
    sim.join()
    return time.perf_counter() - t0


def phase_headline(card, n, fuse, iters, chunk):
    """Warm run (compiles), then a timed run of ``iters`` iterations."""
    warm, _ = headline_sim(n, chunk, chunk, fuse=fuse)
    t_warm = run_timed(warm)
    sim, meas = headline_sim(n, iters, chunk, fuse=fuse, seed=1)
    wall = run_timed(sim)
    want_fused = fuse == "auto"
    if sim.used_fused != want_fused:
        raise SystemExit(f"used_fused={sim.used_fused} with fuse={fuse}\n"
                         + sim.explain_plan())
    if len(sim.ts) != iters:
        raise SystemExit(f"ran {len(sim.ts)} iterations, wanted {iters}")
    err, _ = sign_law_error(meas)
    if not err < 0.02:
        raise SystemExit(f"sign-share law off by {err} (limit 0.02)")
    rate = n * iters / wall
    tier = "fused" if want_fused else "generic scan"
    log(f"  {tier}: {n} photons x {iters} iterations in {wall:.3f} s "
        f"start()->join() (first run incl. compile {t_warm:.1f} s) = "
        f"{rate:.4e} photon-steps/s on {card}; sign-law error {err:.4f}")
    if want_fused:
        log("  " + sim.explain_plan().replace("\n", "\n  "))
    return rate


def time_chunk(run, args, reps=3):
    import jax

    jax.block_until_ready(run(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(run(*args))
    return (time.perf_counter() - t0) / reps


def phase_families(card, kinds, photons, iters, out_dir):
    """Triton kernel against the XLA chunk, family by family."""
    import jax
    from physicl_tpu.ops import families as FA
    from physicl_tpu.ops import fused as F

    rows, bad = [], []
    for kind in kinds:
        plan = FA.family_plan(kind, chunk=iters)
        args = FA.family_inputs(plan, photons, seed=1)
        args = (jax.device_put(args[0]),) + args[1:] + (1234, iters)
        res, rate, comp = {}, {}, {}
        routed, why = F.choose_builder(plan)
        if F.kernel_lowers(plan) is not None:  # no kernel to compare
            run = F._build_xla_chunk(plan, photons)
            rate["xla"] = photons * iters / time_chunk(run, args)
            rows.append(dict(family=kind, planner=routed, reason=why,
                             xla_rate=rate["xla"]))
            log(f"  {kind:18s} xla {rate['xla']:.4e} photon-steps/s; "
                f"planner: xla ({why})")
            continue
        for builder in ("xla", "triton"):
            t0 = time.perf_counter()
            run = (F._build_xla_chunk(plan, photons) if builder == "xla"
                   else F._build_triton_chunk(plan, photons))
            res[builder] = jax.device_get(run(*args))
            comp[builder] = time.perf_counter() - t0
            rate[builder] = photons * iters / time_chunk(run, args)
        cmp = FA.compare_chunks(plan, res["xla"], res["triton"])
        row = dict(family=kind, planner=routed, reason=why,
                   xla_rate=rate["xla"],
                   triton_rate=rate["triton"], first_call_s=comp, **cmp)
        rows.append(row)
        log(f"  {kind:18s} xla {rate['xla']:.4e}  triton "
            f"{rate['triton']:.4e} photon-steps/s  (x"
            f"{rate['triton'] / rate['xla']:.2f}; planner: {routed}); "
            f"branched {cmp['branched']}/{photons}, alive flips "
            f"{cmp['alive_flips']}, int tally err {cmp['int_tally_err']}, "
            f"float tally rel {cmp['float_tally_rel']:.2e}; first calls "
            f"{comp['xla']:.1f}/{comp['triton']:.1f} s "
            f"{'ok' if cmp['ok'] else 'FAIL'}")
        if not cmp["ok"]:
            bad.append(kind)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "families.json"), "w") as fh:
        json.dump({"card": card, "photons": photons, "iterations": iters,
                   "rows": rows}, fh, indent=1)
    if bad:
        raise SystemExit(f"kernel/XLA parity failed for {bad}")


def phase_validate():
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import validate_chip

    validate_chip.main()


def phase_multi(card, n_per_card):
    """Four-card mesh: fused and generic legs plus the headline, with the
    layout, census and one-card statistical checks."""
    import jax
    from __graft_entry__ import mesh_legs
    from physicl_tpu.parallel import make_mesh

    n_dev = len(jax.devices())
    if n_dev != 4:
        raise SystemExit(f"--multi needs 4 GPUs, found {n_dev}")
    mesh = make_mesh(4)
    t0 = time.perf_counter()
    mesh_legs(mesh, n_per_card)
    log(f"  mesh legs (fused + generic) at {n_per_card} photons per card: "
        f"exact census ok, {time.perf_counter() - t0:.1f} s")
    iters, chunk = 512, 256
    n = 4 * n_per_card
    sim, meas = headline_sim(n, iters, chunk, mesh=mesh)
    wall = run_timed(sim)
    if not sim.used_fused:
        raise SystemExit(sim.explain_plan())
    shards = sim.sim_state.r.addressable_shards
    devs = {s.device for s in shards}
    widths = sorted(s.data.shape[-1] for s in shards)
    cap = sim.sim_state.capacity
    if len(devs) != 4 or widths != [cap // 4] * 4:
        raise SystemExit(f"particle planes not split in quarters: "
                         f"{widths} over {len(devs)} devices (cap {cap})")
    data = np.asarray(meas.data, np.float64)
    if not (data[:, 1] == n).all():
        raise SystemExit(f"census: alive counts {set(data[:, 1])} != {n}")
    err4, sh4 = sign_law_error(meas)
    one, meas1 = headline_sim(n, iters, chunk, mesh=None, seed=5)
    run_timed(one)
    err1, sh1 = sign_law_error(meas1)
    # binomial share noise: sd <= 0.5/sqrt(n) per iteration and run
    z = float(np.abs(sh4 - sh1).max() / (0.5 * np.sqrt(2.0 / n)))
    log(f"  headline on make_mesh(4): {n} photons ({n_per_card} per card, "
        f"quarter shards {widths[0]}) x {iters} iterations, "
        f"{n * iters / wall:.4e} photon-steps/s start()->join() on 4 x "
        f"{card}; sign-law error {err4:.4f} (one card {err1:.4f}); largest "
        f"per-iteration share difference to one card {z:.2f} sd")
    if not (err4 < 0.02 and z < 6.0):
        raise SystemExit("four-card tallies disagree with one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh path (needs 4 GPUs)")
    ap.add_argument("--phase", type=int, action="append",
                    help="run only these phases (1-4)")
    ap.add_argument("--families", default="",
                    help="comma-separated phase-3 families (default: all)")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import physicl_tpu  # noqa: F401 — fails when the repository is absent
    from physicl_tpu.ops import families as FA
    from physicl_tpu.utils.cache import enable_persistent_compilation_cache

    card = card_line()
    log(f"card: {card}")
    log(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}; "
        f"compile cache: {enable_persistent_compilation_cache()}")
    if args.multi:
        log("multi: four-card mesh path")
        phase_multi(card, 1_000_000)
    else:
        phases = args.phase or [1, 2, 3, 4]
        if 1 in phases:
            log("phase 1: headline Simulation, fused tier")
            phase_headline(card, 10_000_000, "auto", 4096, 1024)
        if 2 in phases:
            log("phase 2: headline Simulation, generic scan")
            phase_headline(card, 10_000_000, "off", 512, 256)
        if 3 in phases:
            log("phase 3: Triton kernel vs XLA chunk per op family")
            kinds = ([k for k in args.families.split(",") if k]
                     or list(FA.FAMILIES))
            phase_families(card, kinds, 1 << 20, 256,
                           os.path.join(HERE, "chiprun_out"))
        if 4 in phases:
            log("phase 4: physics validation (scripts/validate_chip.py)")
            phase_validate()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
