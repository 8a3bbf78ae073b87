"""Fused chunk builders on the GPU: kernel launch-shape sweep per family.

    python3 benchmarks/builders.py --families iso,compton --shapes 1x2,2x4

For each family of ``physicl_tpu/ops/families.py``, times the Triton chunk
kernel over launch shapes ``RxW`` (R rows of 128 photons per program, W
warps) beside the XLA chunk, at the given population and 256 iterations.
Prints one line per shape and writes ``chiprun_out/builders_sweep.json``.
Rates are chunk rates (photon-steps/s of ``build_fused_chunk``'s runner,
timed with ``block_until_ready``); ``chip_smoke.py`` times the same runners
and the end-to-end ``Simulation`` headline.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--families", default="iso")
    ap.add_argument("--photons", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=256)
    ap.add_argument("--shapes", default="1x2,2x4,4x4")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    from physicl_tpu.ops import families as FA
    from physicl_tpu.ops import fused as F

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    def rate(run, a):
        jax.block_until_ready(run(*a))
        t0 = time.perf_counter()
        for _ in range(3):
            jax.block_until_ready(run(*a))
        return args.photons * args.iters * 3 / (time.perf_counter() - t0)

    out = []
    for kind in args.families.split(","):
        base = FA.family_plan(kind, chunk=args.iters)
        inp = FA.family_inputs(base, args.photons, seed=1)
        a = (jax.device_put(inp[0]),) + inp[1:] + (1234, args.iters)
        r_xla = rate(F._build_xla_chunk(base, args.photons), a)
        print(f"{kind} xla {r_xla:.4e}", flush=True)
        out.append(dict(family=kind, builder="xla", rate=r_xla))
        for shape in args.shapes.split(","):
            rows, warps = map(int, shape.split("x"))
            plan = dataclasses.replace(base, tile_rows=rows, num_warps=warps)
            t0 = time.perf_counter()
            run = F._build_triton_chunk(plan, args.photons)
            jax.block_until_ready(run(*a))
            comp = time.perf_counter() - t0
            r = rate(run, a)
            print(f"{kind} triton rows={rows} warps={warps} {r:.4e} "
                  f"(x{r / r_xla:.2f}) first call {comp:.1f} s", flush=True)
            out.append(dict(family=kind, builder="triton", tile_rows=rows,
                            num_warps=warps, rate=r, first_call=comp))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "builders_sweep.json"),
              "w") as fh:
        json.dump({"card": card, "photons": args.photons,
                   "iterations": args.iters, "rows": out}, fh, indent=1)


if __name__ == "__main__":
    main()
