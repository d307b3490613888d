"""chip_smoke.py's demo and content phases alone, on the card: the card's
name and power limit, the broadphase kernels' build (the demo's
reference step launches the overlap matrix), then the demo phase and the
content phase, each one JSON line as in the full smoke. Exits non-zero if
either phase fails (both run).

    python3 tools/demo_content_chip.py [--only demo|content] [--seed 0]
"""

import argparse
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("demo", "content"), default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's --seed (the phases add 15 and 16)")
    args = ap.parse_args()
    import chip_smoke
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    print(chip_smoke.device_phase(), flush=True)
    t0 = time.perf_counter()
    bk.load_library()
    print(f"broadphase build {time.perf_counter() - t0:.1f} s", flush=True)
    failed = False
    if args.only in (None, "demo"):
        try:
            chip_smoke.demo_phase(args.seed + 15)
        except Exception:
            traceback.print_exc()
            failed = True
    if args.only in (None, "content"):
        try:
            chip_smoke.content_phase(args.seed + 16)
        except Exception:
            traceback.print_exc()
            failed = True
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
