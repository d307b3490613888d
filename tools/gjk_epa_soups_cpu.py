"""GJK + EPA against the analytic cylinder-box and cylinder-cylinder recipes
on chip_smoke.py's content soups, in the JAX package on the CPU: what the
content phase's analytic gates are set from.

Draws chip_smoke._jax_test_soup's pairs (tests/test_gjk_epa.py's
distributions, drawn with numpy) for the seeds the content phase uses,
runs the JAX package's gjk_intersection + epa (24 EPA iterations, as the
JAX test) and its analytic recipe, compiled under vmap, and prints one JSON
line per pairing with the statistics the JAX test bounds: hit agreement,
the share of pairs whose normals agree or depths are within 0.01, the 90th
percentile and the largest depth gap (pairs both call hits, depth < 0.3,
cylinder-cylinder axes not parallel).

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_disable_hlo_passes=fusion \\
        python3 tools/gjk_epa_soups_cpu.py [--pairs 65536] [--seed 16]
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=16,
                    help="chip_smoke.py's content seed (its --seed + 16)")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from dxk_tpu.ops import narrowphase as jnp_aos
    from dxk_tpu.ops.epa import epa
    from dxk_tpu.ops.gjk import (gjk_intersection, support_box,
                                 support_cylinder)
    shapes = chip_smoke.CONTENT_SHAPES
    for ka, kb in chip_smoke.CONTENT_JAX_SOUPS:
        i = shapes.index(ka)
        rng = np.random.default_rng(args.seed + 31 * i + shapes.index(kb))
        pa, pb = chip_smoke._jax_test_soup(ka, kb, rng, args.pairs, "cpu")
        pa = tuple(jnp.asarray(x.numpy()) for x in pa)
        pb = tuple(jnp.asarray(x.numpy()) for x in pb)
        sb = support_box if kb == "box" else support_cylinder
        recipe = (jnp_aos.cylinder_box_contact if kb == "box"
                  else jnp_aos.cylinder_cylinder_contact)

        def one(a, b):
            hit, s = gjk_intersection(support_cylinder, sb, a, b)
            _p, n, d = epa(support_cylinder, sb, a, b, s, max_iterations=24)
            _pts, dps, nrm, _cnt, ahit = recipe(*a, *b)
            return hit, n, d, ahit, dps[0], nrm
        hit, n, d, ahit, adepth, anrm = (np.asarray(x) for x in jax.jit(
            jax.vmap(one))(pa, pb))
        valid = np.ones_like(hit)
        if kb == "cylinder":
            ua = np.asarray(pa[1] - pa[0])
            ub = np.asarray(pb[1] - pb[0])
            cos = (ua * ub).sum(-1) / (np.linalg.norm(ua, axis=-1)
                                       * np.linalg.norm(ub, axis=-1))
            valid = np.abs(cos) <= 0.99
        both = hit & ahit & valid & (d < 0.3)
        dd = np.abs(adepth - d)[both]
        ok = ((anrm * n).sum(-1)[both] > 0.9) | (dd < 0.01)
        print(json.dumps(dict(
            pairing=f"{ka}-{kb}", pairs=args.pairs, seed=args.seed,
            hit_share=float(hit.mean()),
            hit_agreement=float(((hit == ahit) | ~valid).mean()),
            normal_or_depth_ok=float(ok.mean()),
            depth_p90=float(np.percentile(dd, 90)),
            depth_max=float(dd.max()))), flush=True)


if __name__ == "__main__":
    main()
